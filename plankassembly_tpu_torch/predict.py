"""One-command inference with the port: info JSONs or the three view SVGs
of a drawing -> predicted shape programs (+ optional meshes). No ground
truth needed. The port's counterpart of `tools/predict.py`.

  python -m plankassembly_tpu_torch.predict --ckpt checkpoints/gqa_complete_ep221.npz \\
      --info drawing.json --out preds/
  python -m plankassembly_tpu_torch.predict --ckpt <run>/checkpoints/best.pt \\
      --svg front.svg top.svg side.svg --out preds/ --mesh glb
  ... --cpu                      # the plain PyTorch versions on the CPU

The checkpoint is a released `.npz` (its `.hparams.yaml` beside it) or a
training checkpoint of the port (its run's `hparams.yaml`); the model's
shape comes from those hparams. Samples are decoded in batches of similar
input length, each at its smallest kv bucket (`decode.pick_kv_bucket`),
in bfloat16, greedily (`--decode_impl`, int8 cross K/V) or by beam search
(`--beam`). One `<name>.json` per sample ({"prediction", "attach"}), and
with `--mesh` a `<name>.stl` / `<name>.glb`. Without `--cpu` it runs on
the GPU and raises if CUDA is absent.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from plankassembly_tpu_torch.checkpoint import load_checkpoint
from plankassembly_tpu_torch.config import ModelDims
from plankassembly_tpu_torch.decode import IMPLS
from plankassembly_tpu_torch.device import resolve_device

ARTIFACT_TODO = "not ported yet (ROADMAP.md §1, item 6: export artifacts)"


def sample_from_info(path, cfg):
    """(name, packed input streams) of one info JSON."""
    from plankassembly_tpu_torch.serving import pack_info_dict

    with open(path) as f:
        info = json.load(f)
    name = info.get("name", os.path.splitext(os.path.basename(path))[0])
    return name, pack_info_dict(info, cfg)


def sample_from_svgs(paths, cfg, name="sample"):
    """(name, packed input streams) of one drawing's view SVGs (front,
    top, side)."""
    from plankassembly_tpu_torch.data import geometry as geo
    from plankassembly_tpu_torch.data.packing import pack_input_sequence
    from plankassembly_tpu_torch.io.svg import parse_svg

    if len(paths) != cfg.DATA.NUM_VIEW:
        raise SystemExit(f"need {cfg.DATA.NUM_VIEW} view SVGs, got "
                         f"{len(paths)}")
    lines, views, types = [], [], []
    for v_i, p in enumerate(paths):
        ls, ts = parse_svg(p)
        lines.extend(ls)
        types.extend(ts)
        views.extend([v_i] * len(ls))
    return name, pack_input_sequence(
        geo.bounds_many(lines), np.asarray(views), np.asarray(types),
        cfg.DATA, cfg.TOKEN, with_type=True)


def write_prediction(out_dir, name, sample_row, attach_row, dims, mesh=None):
    from plankassembly_tpu_torch.serving import postprocess_prediction
    from plankassembly_tpu_torch.tokens import dequantize_values

    pred, attach = postprocess_prediction(sample_row, attach_row, dims)
    with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
        json.dump({"prediction": pred.tolist(), "attach": attach},
                  f, indent=4, separators=(", ", ": "))
    if mesh and len(pred) > 1:
        from plankassembly_tpu_torch.io.mesh import (
            build_mesh, export_glb, export_stl,
        )
        verts, faces = build_mesh(dequantize_values(pred))
        export = export_stl if mesh == "stl" else export_glb
        export(os.path.join(out_dir, f"{name}.{mesh}"), verts, faces)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m plankassembly_tpu_torch.predict",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", required=True,
                    help="released .npz or a training checkpoint of the port")
    ap.add_argument("--artifact", default=None,
                    help=f"serving artifact: {ARTIFACT_TODO}")
    ap.add_argument("--hparams", default=None,
                    help="hparams.yaml (default: beside the checkpoint)")
    ap.add_argument("--info", nargs="*", action="append", default=[],
                    help="info JSON files; repeatable, each occurrence "
                    "takes one or more paths")
    ap.add_argument("--info_dir", default=None,
                    help="directory of info JSONs (all *.json)")
    ap.add_argument("--svg", nargs="*", default=[],
                    help="the three view SVGs of one drawing (front top side)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--mesh", choices=("stl", "glb"), default=None,
                    help="also write a mesh per prediction")
    ap.add_argument("--batch", type=int, default=32,
                    help="largest decode batch")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    ap.add_argument("--decode_impl", default="auto", choices=IMPLS,
                    help="greedy decode path (decode.decode_from_memory); "
                    "'auto' takes the persistent kernels on a GPU")
    ap.add_argument("--beam", type=int, default=1,
                    help="beam width; > 1 decodes by beam search")
    ap.add_argument("--alpha", type=float, default=0.0,
                    help="GNMT length-normalization exponent for --beam > 1")
    args = ap.parse_args(argv)
    if args.artifact:
        ap.error(f"--artifact: {ARTIFACT_TODO}")
    return args


def main(argv=None) -> int:
    from plankassembly_tpu_torch.beam import beam_decode
    from plankassembly_tpu_torch.decode import greedy_decode, pick_kv_bucket

    args = parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    params, cfg = load_checkpoint(args.ckpt, args.hparams, device=dev)
    dims = ModelDims.from_config(cfg)

    paths = [p for group in args.info for p in group]
    if args.info_dir:
        paths += sorted(os.path.join(args.info_dir, f)
                        for f in os.listdir(args.info_dir)
                        if f.endswith(".json"))
    samples = [sample_from_info(p, cfg) for p in paths]
    if args.svg:
        samples.append(sample_from_svgs(args.svg, cfg))
    if not samples:
        raise SystemExit("no inputs: pass --info/--info_dir and/or --svg")

    os.makedirs(args.out, exist_ok=True)
    # programs of similar input length share a batch, so it exits early
    # together and takes a small kv bucket; outputs are per-name files
    samples.sort(key=lambda s: int((~s[1]["input_mask"]).sum()))
    for lo in range(0, len(samples), args.batch):
        chunk = samples[lo:lo + args.batch]
        batch = {k: torch.from_numpy(np.stack([s[1][k] for s in chunk]))
                 .to(dev) for k in chunk[0][1]}
        bucket = pick_kv_bucket(np.stack([s[1]["input_mask"]
                                          for s in chunk]))
        if args.beam > 1:
            out = beam_decode(params, batch, dims, num_beams=args.beam,
                              compute_dtype=torch.bfloat16,
                              alpha=args.alpha, kv_bucket=bucket)
        else:
            out = greedy_decode(params, batch, dims,
                                compute_dtype=torch.bfloat16,
                                kv_bucket=bucket, kv_quant=True,
                                cross_impl=args.decode_impl)
        rows, att = out["samples"].cpu().numpy(), out["attach"].cpu().numpy()
        for i, (name, _) in enumerate(chunk):
            write_prediction(args.out, name, rows[i], att[i], dims,
                             mesh=args.mesh)
    print(f"predicted {len(samples)} samples -> {args.out}")
    return len(samples)


if __name__ == "__main__":
    main()
