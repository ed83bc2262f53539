#!/usr/bin/env python
"""Write the JAX package's golden of the offline data factory and of the
robustness sweep, for the PyTorch port.

  python tests/make_torch_factory_golden.py [--cache DIR]

Runs the JAX package's own tools on the 64 serving seeds (900000-900063,
the drawings of `fixtures/serve64.json.gz`), every one in the test split:

  tools/generate_models.py --seed 900000 --count 64 --test_frac 1.0
  tools/render_svgs.py --data_type {complete,visible,noise_05,noise_10}
  tools/prepare_info.py --data_type {complete,visible,noise_05,noise_10}

and writes plankassembly_tpu_torch/fixtures/factory_jax_golden.json with
the sha256 of each model JSON, SVG and info JSON (by path under the
dataset root), the split files, and the P/R/F1 of
`checkpoints/gqa_complete_ep221.npz` over the complete, noise_05 and
noise_10 test sets in bfloat16 and float32: JAX's `Trainer.test` with
`trainer.decode_impl xla` and `trainer.kv_quant true` (that is
``greedy_decode(kv_quant=True, self_quant=False, cross_impl="xla")`` at
each batch's kv bucket) on configs/train_synthetic_gqa.yaml. This script
imports JAX and the JAX package, so it lives with the tests; the port
only reads the golden file.
"""
import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FIXTURES = os.path.join(ROOT, "plankassembly_tpu_torch", "fixtures")
CKPT = os.path.join(ROOT, "checkpoints", "gqa_complete_ep221.npz")
CONFIG = os.path.join(ROOT, "configs", "train_synthetic_gqa.yaml")
SEED, COUNT = 900000, 64
GENERATE_FLAGS = ["--seed", str(SEED), "--count", str(COUNT),
                  "--test_frac", "1.0"]
VARIANTS = ("complete", "visible", "noise_05", "noise_10")
SWEEP_VARIANTS = ("complete", "noise_05", "noise_10")


def sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def digests(root: str) -> dict:
    """{path under root: sha256} of every file but the splits."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, root)
            if not rel.startswith("splits"):
                out[rel] = sha256(path)
    return dict(sorted(out.items()))


def build_dataset(root: str):
    def tool(name, *flags):
        subprocess.run([sys.executable, os.path.join(ROOT, "tools", name),
                        *flags], check=True, cwd=ROOT)

    tool("generate_models.py", "--root", root, *GENERATE_FLAGS)
    for variant in VARIANTS:
        tool("render_svgs.py", "--root", root, "--data_type", variant,
             "--max_workers", "1")
        tool("prepare_info.py", "--data_path", root, "--data_type", variant,
             "--max_workers", "1")


def sweep_scores(root: str, log_root: str) -> dict:
    """{variant: {bf16|f32: {precision, recall, fmeasure}}} of JAX's
    Trainer.test."""
    import dataclasses

    import jax.numpy as jnp

    from plankassembly_tpu.config import load_config
    from plankassembly_tpu.train import Trainer
    from plankassembly_tpu.train.state import TrainState
    from tools.predict import load_params_and_config

    params, _ = load_params_and_config(CKPT)
    out = {}
    for variant in SWEEP_VARIANTS:
        out[variant] = {}
        for name, cd in (("bf16", jnp.bfloat16), ("f32", jnp.float32)):
            cfg = load_config(CONFIG, {
                "trainer.decode_impl": "xla", "trainer.kv_quant": "true",
                "model.hparams.DATASETS_TEST":
                    os.path.join(root, "splits", "test.txt")})
            cfg = dataclasses.replace(cfg, ROOT=os.path.join(
                root, "data", variant, "infos"))
            trainer = Trainer(cfg, log_dir=os.path.join(
                log_root, f"{variant}_{name}"), compute_dtype=cd)
            prec, rec, f1 = trainer.test(
                TrainState(params, None, jnp.int32(0)))
            out[variant][name] = {"precision": prec, "recall": rec,
                                  "fmeasure": f1}
            print(f"{variant} {name}: P {prec:.6f} R {rec:.6f} F1 {f1:.6f}",
                  flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cache", default=None,
                    help="JAX persistent compilation cache directory")
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    if args.cache:
        jax.config.update("jax_compilation_cache_dir", args.cache)

    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "data")
        build_dataset(root)
        splits = {}
        for name in sorted(os.listdir(os.path.join(root, "splits"))):
            with open(os.path.join(root, "splits", name)) as f:
                splits[name] = f.read()
        golden = {
            "generate_flags": GENERATE_FLAGS,
            "variants": list(VARIANTS),
            "splits": splits,
            "sha256": digests(root),
            "sweep": {"ckpt": os.path.basename(CKPT),
                      "config": os.path.relpath(CONFIG, ROOT),
                      "overrides": {"trainer.decode_impl": "xla",
                                    "trainer.kv_quant": "true"},
                      "scores": sweep_scores(root, os.path.join(tmp, "runs"))},
        }
    with open(os.path.join(FIXTURES, "factory_jax_golden.json"), "w") as f:
        json.dump(golden, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"{len(golden['sha256'])} digests")


if __name__ == "__main__":
    main()
