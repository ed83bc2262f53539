"""Export a checkpoint as a serving artifact of the port (`export.py`); the
port's counterpart of `tools/export_serving.py`.

  python -m plankassembly_tpu_torch.export_serving \\
      --ckpt checkpoints/gqa_complete_ep221.npz --batch 16 --bucket 512 \\
      --out serving/complete_b16_k512.ptrv [--beam 4] [--weight_quant] [--verify]
  ... --bucket 512,768,1152      # a ladder: one artifact per bucket
  ... --cpu                      # the plain PyTorch versions on the CPU

A comma list of buckets writes one artifact per bucket, `.k<bucket>`
inserted before the --out extension, for `serve --artifact a b c`.
`--verify` loads the widest artifact and checks its programs bit for bit
against the live decode of the same weights on a random request. The
artifact holds the weights and the serving contract, not a compiled
program: it runs on the device it is loaded on, so `--platforms` (JAX's
lowering targets) is refused. `--data_parallel N` splits each request's
rows over the first N GPUs, which must be visible where it is exported
and loaded. Without --cpu it runs on the GPU and raises if CUDA is
absent.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from plankassembly_tpu_torch.checkpoint import load_checkpoint
from plankassembly_tpu_torch.config import ModelDims
from plankassembly_tpu_torch.device import resolve_device
from plankassembly_tpu_torch.export import (
    export_serving, load_artifact, save_artifact,
)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m plankassembly_tpu_torch.export_serving",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", required=True,
                    help="released .npz or a training checkpoint of the port")
    ap.add_argument("--hparams", default=None,
                    help="hparams.yaml (default: beside the checkpoint)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--bucket", default="512",
                    help="input width; a comma list exports a ladder")
    ap.add_argument("--beam", type=int, default=0,
                    help=">= 2 serves beam search of that width")
    ap.add_argument("--platforms", default=None,
                    help="refused: an artifact of the port is not lowered "
                    "for platforms")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--weight_quant", action="store_true",
                    help="store int8 decoder and head weights")
    ap.add_argument("--data_parallel", type=int, default=1,
                    help="split each request's rows over this many GPUs")
    ap.add_argument("--no_input_type", action="store_true",
                    help="sideface input contract: no line-type stream")
    ap.add_argument("--verify", action="store_true",
                    help="check the widest artifact against the live decode")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)
    if args.platforms is not None:
        ap.error("--platforms: an artifact of the port holds weights, not a "
                 "program lowered for platforms; it runs on the device it is "
                 "loaded on (--cpu for the CPU)")
    return args


def random_request(dims: ModelDims, rows: int, width: int, with_type: bool,
                   seed: int = 7) -> dict:
    """A structurally plausible random request of `rows` x `width` input
    tokens: real tokens, END, then PAD."""
    rng = np.random.default_rng(seed)
    n_in = width - 4
    value = rng.integers(0, dims.end, (rows, width))
    value[:, n_in] = dims.end
    value[:, n_in + 1:] = dims.pad
    req = {"input_value": value,
           "input_pos": rng.integers(0, dims.max_num_input, (rows, width)),
           "input_coord": np.tile(np.arange(width) % dims.num_input_dof,
                                  (rows, 1)),
           "input_view": rng.integers(0, dims.num_view, (rows, width)),
           "input_mask": value == dims.pad}
    if with_type:
        req["input_type"] = rng.integers(0, dims.num_type, (rows, width))
    return req


def verify(path, params, dims, device) -> None:
    """The artifact's programs against the live decode of `params` on a
    random request: equal samples and attach, or AssertionError."""
    from plankassembly_tpu_torch.beam import beam_decode
    from plankassembly_tpu_torch.decode import (
        greedy_decode, quantize_decoder_weights,
    )

    prog = load_artifact(path, device=device)
    meta = prog.meta
    req = random_request(dims, meta["batch"], meta["bucket"],
                         meta["with_type"])
    got = prog(req)
    if meta["weight_quant"]:
        params = quantize_decoder_weights(params)
    inputs = {k: torch.from_numpy(v).to(device) for k, v in req.items()}
    cd = getattr(torch, meta["compute_dtype"])
    if meta["beam"] >= 2:
        want = beam_decode(params, inputs, dims, num_beams=meta["beam"],
                           compute_dtype=cd)
    else:
        want = greedy_decode(params, inputs, dims, compute_dtype=cd,
                             kv_bucket=meta["bucket"], kv_quant=True,
                             cross_impl=meta["decode"]["cross_impl"])
    np.testing.assert_array_equal(got["samples"],
                                  want["samples"].cpu().numpy())
    np.testing.assert_array_equal(got["attach"], want["attach"].cpu().numpy())


def main(argv=None) -> list[str]:
    """Write the artifacts; returns their paths."""
    args = parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    params, cfg = load_checkpoint(args.ckpt, args.hparams, device=dev)
    dtype = getattr(torch, args.dtype)
    buckets = [int(b) for b in str(args.bucket).split(",") if b.strip()]
    stem, ext = os.path.splitext(args.out)
    outs = ([args.out] if len(buckets) == 1 else
            [f"{stem}.k{b}{ext}" for b in buckets])
    for bucket, out in zip(buckets, outs):
        blob, meta = export_serving(
            params, cfg, batch=args.batch, bucket=bucket, beam=args.beam,
            compute_dtype=dtype, weight_quant=args.weight_quant,
            data_parallel=args.data_parallel,
            with_type=not args.no_input_type)
        meta["checkpoint"] = os.path.basename(args.ckpt)
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        save_artifact(out, blob, meta)
        print(f"wrote {out}: {os.path.getsize(out) / 1e6:.1f} MB, "
              f"batch={meta['batch']} bucket={meta['bucket']} "
              f"beam={meta['beam']} weight_quant={meta['weight_quant']}",
              flush=True)
    if args.verify:  # the widest rung
        verify(outs[-1], params, ModelDims.from_config(cfg), dev)
        print("verify: artifact programs bit-exact vs the live decode",
              flush=True)
    return outs


if __name__ == "__main__":
    main()
