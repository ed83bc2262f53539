"""Noisy-input robustness sweep: one checkpoint over the clean and the
noise_05 / noise_10 test sets (the paper's robustness experiment,
`README.md:88`, `dataset/render_noisy_svg.py:140-145`); the port's
counterpart of `tools/robustness_sweep.py`.

  python -m plankassembly_tpu_torch.tools.robustness_sweep \\
      --config configs/train_synthetic_gqa.yaml \\
      --ckpt_path checkpoints/gqa_complete_ep221.npz --data_root data \\
      [--variants complete noise_05 noise_10] [--precision bf16|f32] \\
      [--device cuda|cpu] [--out_dir DIR] [--trainer.decode_impl persistent ...]

Each variant is `Trainer.test` over `<data_root>/data/<variant>/infos`
and the config's DATASETS_TEST split, its prediction JSONs under
`<out_dir>/sweep_<variant>/pred_jsons`. The checkpoint is a released
`.npz` or a training checkpoint of the port (`.pt`). Any other
``--dot.path value`` pair overrides the config, as the port's CLI takes
them. Prints one row per variant and writes `<out_dir>/sweep.json`
(`out_dir` defaults to the checkpoint's directory).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def main(argv=None) -> dict:
    from plankassembly_tpu_torch.config import load_config
    from plankassembly_tpu_torch.train.loop import Trainer

    args, overrides = parse_args(argv)
    out_dir = args.out_dir or os.path.dirname(os.path.abspath(args.ckpt_path))
    results = {}
    for variant in args.variants:
        cfg = load_config(args.config, overrides)
        root = os.path.join(args.data_root, "data", variant, "infos")
        cfg = dataclasses.replace(cfg, ROOT=root)
        trainer = Trainer(cfg, log_dir=os.path.join(out_dir,
                                                    f"sweep_{variant}"),
                          compute_dtype=DTYPES[args.precision],
                          device=args.device)
        try:
            state = trainer.load_checkpoint(args.ckpt_path)
            prec, rec, f1 = trainer.test(state)
        finally:
            trainer.close()
        results[variant] = {"precision": prec, "recall": rec, "fmeasure": f1}
        print(f"{variant:>10s}  prec={prec:.4f} rec={rec:.4f} f1={f1:.4f}",
              flush=True)

    out = os.path.join(out_dir, "sweep.json")
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    print(f"wrote {out}")
    return results


def parse_args(argv=None):
    """(arguments, config overrides {dotted path: value})."""
    parser = argparse.ArgumentParser(
        prog="python -m plankassembly_tpu_torch.tools.robustness_sweep",
        description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--ckpt_path", required=True)
    parser.add_argument("--data_root", default="data")
    parser.add_argument("--variants", nargs="+",
                        default=["complete", "noise_05", "noise_10"])
    parser.add_argument("--precision", choices=tuple(DTYPES), default="bf16",
                        help="compute dtype of the decode")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    parser.add_argument("--out_dir", default=None,
                        help="where sweep.json and the test runs go "
                        "(default: the checkpoint's directory)")
    args, rest = parser.parse_known_args(argv)
    if len(rest) % 2 or any(not k.startswith("--") for k in rest[::2]):
        parser.error(f"config overrides come as --dot.path value pairs, "
                     f"got {rest}")
    return args, {k[2:]: v for k, v in zip(rest[::2], rest[1::2])}


if __name__ == "__main__":
    main()
