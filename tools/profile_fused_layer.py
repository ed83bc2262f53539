#!/usr/bin/env python3
"""Where one fused decoder layer's device time goes, kernel by kernel, on
one NVIDIA GPU.

  python3 tools/profile_fused_layer.py [--tree DIR] [--dtype bf16]
      [--reps 20] [--errors] [--trajectory]

Encodes the last 32 drawings of the serving fixture with
checkpoints/mha_complete_ep59.npz (bucket 1152), runs the `fused` decode
(decode.FusedDecode) to step 48, then profiles `--reps` calls of
ops.fused_decode.fused_decoder_layer (with its fused_ffn) at layer 3, as
chip_smoke.py's mha_kernels phase does, and prints each kernel's launches
and device time per call and the kernels' time by CUDA events.

--errors also prints, for every layer at steps 16 and 32, and at step
48, layer 3, the kernels' worst row error against the plain versions over the row's
largest value (chip_smoke.py's FUSED_ROW_TOL measure); at step 48, layer
3, also with the FFN's output weights zeroed (attention only) and with
the cross output weights zeroed too (self-attention only).

--trajectory also holds the kernels to the plain versions along the plain
version's own decode, every layer at chip_smoke.py's TRAJ_STEPS, and
prints its counts: rows over FUSED_ROW_TOL, the planted fault's, and the
new K/V's int8 flips (chip_smoke.py's mha_kernels check).

--tree imports plankassembly_tpu_torch from another checkout, such as an
earlier commit unpacked with `git archive` into a git-ignored directory,
so that two versions of the kernels are measured in one run on one card
(the checkpoint and fixtures still come from this checkout). Needs CUDA.
"""
import argparse
import gzip
import importlib.util
import json
import math
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=ROOT,
                    help="checkout whose plankassembly_tpu_torch to run")
    ap.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--errors", action="store_true")
    ap.add_argument("--trajectory", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_fused_layer: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.tree))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    from plankassembly_tpu_torch.checkpoint import load_checkpoint
    from plankassembly_tpu_torch.config import ModelDims
    from plankassembly_tpu_torch.decode import FusedDecode, _pad_or_crop
    from plankassembly_tpu_torch.models.model import encode
    from plankassembly_tpu_torch.ops import fused_decode as FD
    from plankassembly_tpu_torch.serving import pack_info_dict

    torch.backends.cuda.matmul.allow_tf32 = False
    params, cfg = load_checkpoint(cs.MHA_CKPT, device="cuda")
    dims = ModelDims.from_config(cfg)
    with gzip.open(os.path.join(cs.FIXTURES, "serve64.json.gz"), "rt") as f:
        infos = json.load(f)[-max(cs.REQUESTS):]
    bucket = int(np.load(os.path.join(
        cs.FIXTURES, "serve64_mha_jax_golden.npz"))["bucket"])
    packed = [pack_info_dict(i, cfg) for i in infos]
    req = {k: torch.from_numpy(np.stack([p[k] for p in packed])).cuda()
           for k in packed[0]}
    cd = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    inputs = _pad_or_crop(req, bucket, dims)
    kw = dict(H=dims.num_head, Dh=dims.head_dim,
              sm_scale=1.0 / math.sqrt(dims.head_dim), cd=cd)

    def row_err(largs):
        got = FD.fused_decoder_layer(*largs, **kw)[0]
        ref = FD.fused_decoder_layer_reference(*largs, **kw)[0]
        return ((got - ref).abs().amax(dim=1)
                / ref.abs().amax(dim=1)).max().item()

    errors = {}
    with torch.no_grad():
        memory = encode(params, inputs, dims, compute_dtype=cd, flash=True)
        dec = FusedDecode(params, memory, inputs["input_mask"], dims, cd)
        for t in range(cs.MID_STEP):
            if args.errors and t % 16 == 0 and t:
                x = dec.embed(t)
                for layer in range(dims.num_decoder_layers):
                    errors[f"t{t} l{layer}"] = row_err(
                        (x, t, *dec.layer_args(layer)))
                    x = dec.layer(layer, x, t)
            dec.step(t)
        x = dec.embed(cs.MID_STEP)
        for layer in range(cs.MID_LAYER):
            x = dec.layer(layer, x, cs.MID_STEP)
        largs = (x, cs.MID_STEP, *dec.layer_args(cs.MID_LAYER))
        if args.errors:
            errors[f"t{cs.MID_STEP} l{cs.MID_LAYER}"] = row_err(largs)
            # weights after (x, t): wqkv bqkv wos bos wqc bqc woc boc w1 b1
            # w2 b2 ln ...; zero w2, b2 (attention only), then woc (self)
            zeroed = list(largs)
            for i in (12, 13):
                zeroed[i] = torch.zeros_like(zeroed[i])
            errors["attention only"] = row_err(tuple(zeroed))
            zeroed[8] = torch.zeros_like(zeroed[8])
            errors["self attention only"] = row_err(tuple(zeroed))

        def call():
            return FD.fused_decoder_layer(*largs, **kw)

        rows = cs.kernel_breakdown(call, reps=args.reps)
        events = cs.cuda_ms(call, reps=args.reps, warmup=3)
        traj = (cs.trajectory_summary(cs.fused_trajectory(
            params, memory, inputs["input_mask"], dims, cd))
            if args.trajectory else None)
    print(f"card: {cs.card_line()}")
    print(f"tree {os.path.abspath(args.tree)}, {args.dtype}, B="
          f"{memory.shape[0]} Li={memory.shape[1]} t={cs.MID_STEP} layer "
          f"{cs.MID_LAYER}: fused_decoder_layer with its fused_ffn, "
          f"{args.reps} calls: events {events:.4f} ms per call")
    print("kernels, device time per call: " + cs.breakdown_line(rows))
    if errors:
        print("worst row err / row max against the plain versions: "
              + ", ".join(f"{k} {v:.3e}" for k, v in errors.items()))
    if traj:
        print(cs.trajectory_line(f"fused_decoder_layer {args.dtype}", traj))
    print(json.dumps({"tree": os.path.abspath(args.tree), "errors": errors,
                      "trajectory": traj,
                      "dtype": args.dtype, "events_ms": events,
                      "kernels": [{"kernel": n, "launches": c, "us": us}
                                  for n, c, us in rows]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
