"""Export / import released checkpoints as one compressed npz (the port's
counterpart of `tools/export_checkpoint.py`; an npz written by either
package loads in the other).

  python -m plankassembly_tpu_torch.tools.export_checkpoint export \\
      --ckpt <run>/checkpoints/best.pt --out checkpoints/name.npz
  python -m plankassembly_tpu_torch.tools.export_checkpoint import \\
      --npz checkpoints/name.npz --out <run>/checkpoints/name.pt

Export reads a training checkpoint of the port (`<tag>.pt`, or its path
without the suffix) and writes its parameters cast to bfloat16 in one flat
npz (keys ``a/b/c``, arrays stored as the raw 2-byte void dtype ``|V2``,
the step as ``__step__``), with the run's `hparams.yaml` copied to
`<name>.hparams.yaml` and the checkpoint's `<tag>.meta.json` to
`<name>.meta.json`. Import writes such an npz as a training checkpoint of
the port with a fresh Adam state (a warm start: resuming training
re-estimates the moments; inference and evaluation are exact), and copies
`<name>.hparams.yaml` to the run's `hparams.yaml` (two levels above
`--out`), where `checkpoint.load_checkpoint` looks for it.
"""
from __future__ import annotations

import argparse
import os
import shutil

import numpy as np
import torch

from plankassembly_tpu_torch.checkpoint import (
    _training_file, load_training_params,
)


def _bf16_bytes(t: torch.Tensor) -> np.ndarray:
    """`t` rounded to bfloat16 (to nearest even, as JAX's cast), as a
    ``|V2`` array."""
    bits = t.detach().cpu().to(torch.bfloat16).contiguous().view(torch.int16)
    return bits.numpy().view(np.dtype("V2"))


def do_export(args):
    ckpt = os.path.abspath(_training_file(args.ckpt))
    blob = torch.load(ckpt, map_location="cpu", weights_only=True)
    step = int(blob.get("step", 0))
    flat = {k: _bf16_bytes(v) for k, v in blob["params"].items()}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(args.out, __step__=np.asarray(step), **flat)

    run_dir = os.path.dirname(os.path.dirname(ckpt))
    stem = os.path.splitext(args.out)[0]
    hp = os.path.join(run_dir, "hparams.yaml")
    if os.path.exists(hp):
        shutil.copy(hp, stem + ".hparams.yaml")
    meta = os.path.splitext(ckpt)[0] + ".meta.json"
    if os.path.exists(meta):
        shutil.copy(meta, stem + ".meta.json")
    n = sum(v.size for v in flat.values())
    print(f"exported {n/1e6:.1f}M params (step {step}) -> {args.out} "
          f"({os.path.getsize(args.out)/1e6:.1f} MB)")


def do_import(args):
    from plankassembly_tpu_torch.train.state import (
        init_state, make_optimizer, tree_leaves,
    )

    params, _, step = load_training_params(args.npz)
    opt_state = init_state(params, make_optimizer(args.lr)).optimizer \
        .state_dict()
    out = os.path.abspath(_training_file(args.out))
    os.makedirs(os.path.dirname(out), exist_ok=True)
    flat = {"/".join(p): t for p, t in tree_leaves(params)}
    torch.save({"params": flat, "opt_state": opt_state, "step": step}, out)
    hp_src = os.path.splitext(args.npz)[0] + ".hparams.yaml"
    if os.path.exists(hp_src):
        shutil.copy(hp_src, os.path.join(
            os.path.dirname(os.path.dirname(out)), "hparams.yaml"))
    print(f"imported step-{step} params -> training checkpoint {out} "
          "(fresh optimizer state: warm start)")


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m plankassembly_tpu_torch.tools.export_checkpoint",
        description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    ex = sub.add_parser("export")
    ex.add_argument("--ckpt", required=True)
    ex.add_argument("--out", required=True)
    im = sub.add_parser("import")
    im.add_argument("--npz", required=True)
    im.add_argument("--out", required=True)
    im.add_argument("--lr", type=float, default=1e-4)
    args = ap.parse_args(argv)
    if args.cmd == "export":
        do_export(args)
    else:
        do_import(args)


if __name__ == "__main__":
    main()
