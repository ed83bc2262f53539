#!/usr/bin/env python
"""Write the JAX package's test of the released visible-lines checkpoint
on the 64 serving drawings, for the PyTorch port's check on the card.

  python tests/make_torch_visible_golden.py [--cache DIR]

Renders the serving seeds (900000-900063) as visible-lines drawings with
the JAX package's own tools, as `tests/make_torch_factory_golden.py` does
(every file at that golden's digest):

  tools/generate_models.py --seed 900000 --count 64 --test_frac 1.0
  tools/render_svgs.py --data_type visible
  tools/prepare_info.py --data_type visible

then runs JAX's `VisibleTrainer.test` with
`checkpoints/gqa_visible_ep79.npz` on `configs/train_synthetic_visible_gqa.yaml`
(MAX_INPUT_LENGTH 560, one batch of 64) with ``trainer.decode_impl xla``
and ``trainer.kv_quant true``, in float32 and bfloat16, and writes
plankassembly_tpu_torch/fixtures/serve64_visible_jax_golden.npz: the
drawings' names (the test split's order), each drawing's input length,
the batch's kv bucket, and per dtype the P/R/F1 of the test and the
programs the same decode gives (one row per drawing, by name). This
script imports JAX and the JAX package, so it lives with the tests; the
port only reads the file.
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from tests.make_torch_factory_golden import (  # noqa: E402
    GENERATE_FLAGS, digests,
)

FIXTURES = os.path.join(ROOT, "plankassembly_tpu_torch", "fixtures")
CKPT = os.path.join(ROOT, "checkpoints", "gqa_visible_ep79.npz")
CONFIG = os.path.join(ROOT, "configs", "train_synthetic_visible_gqa.yaml")
OVERRIDES = {"trainer.decode_impl": "xla", "trainer.kv_quant": "true"}


def build_visible(root: str):
    """The serving seeds rendered as visible lines by the JAX tools; raises
    where a file differs from the factory golden's digest."""
    def tool(name, *flags):
        subprocess.run([sys.executable, os.path.join(ROOT, "tools", name),
                        *flags], check=True, cwd=ROOT,
                       env={**os.environ, "PYTHONPATH": ROOT})

    tool("generate_models.py", "--root", root, *GENERATE_FLAGS)
    tool("render_svgs.py", "--root", root, "--data_type", "visible",
         "--max_workers", "1")
    tool("prepare_info.py", "--data_path", root, "--data_type", "visible",
         "--max_workers", "1")
    with open(os.path.join(FIXTURES, "factory_jax_golden.json")) as f:
        golden = json.load(f)["sha256"]
    ours = digests(root)
    bad = [k for k, v in ours.items() if golden.get(k) != v]
    if bad:
        raise SystemExit(f"{len(bad)} files differ from the factory "
                         f"golden: {bad[:5]}")
    return len(ours)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cache", default=None,
                    help="JAX persistent compilation cache directory")
    args = ap.parse_args()
    t0 = time.perf_counter()

    import jax
    jax.config.update("jax_platforms", "cpu")
    if args.cache:
        jax.config.update("jax_compilation_cache_dir", args.cache)
    import jax.numpy as jnp

    from plankassembly_tpu.config import load_config
    from plankassembly_tpu.decode import pick_kv_bucket
    from plankassembly_tpu.train import VisibleTrainer
    from plankassembly_tpu.train.state import TrainState
    from tools.predict import load_params_and_config

    params, _ = load_params_and_config(CKPT)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "data")
        n_files = build_visible(root)
        for tag, cd in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
            cfg = load_config(CONFIG, {
                **OVERRIDES, "model.hparams.DATASETS_TEST":
                    os.path.join(root, "splits", "test.txt")})
            cfg = dataclasses.replace(cfg, ROOT=os.path.join(
                root, "data", "visible", "infos"))
            trainer = VisibleTrainer(cfg, log_dir=os.path.join(tmp, tag),
                                     compute_dtype=cd)
            state = TrainState(params, None, jnp.int32(0))
            prec, rec, f1 = trainer.test(state)
            programs, lengths, buckets = {}, {}, []
            for batch in trainer.test_dataloader():
                _, out_b = trainer._decode_batch(state, batch)
                buckets.append(pick_kv_bucket(
                    batch["input_mask"], quantum=cfg.trainer.kv_quantum))
                samples = np.asarray(out_b["samples"])
                for i, name in enumerate(batch["name"]):
                    if batch["sample_valid"][i]:
                        programs[name] = samples[i]
                        lengths[name] = int((~batch["input_mask"][i]).sum())
            names = sorted(programs)
            out.update({
                f"precision_{tag}": np.float64(prec),
                f"recall_{tag}": np.float64(rec),
                f"fmeasure_{tag}": np.float64(f1),
                f"programs_{tag}": np.stack(
                    [programs[n] for n in names]).astype(np.int32)})
            print(f"{tag}: P {prec:.6f} R {rec:.6f} F1 {f1:.6f}, "
                  f"buckets {buckets}", flush=True)
    out.update({"names": np.array(names),
                "input_lengths": np.array([lengths[n] for n in names]),
                "buckets": np.array(buckets, np.int64),
                "overrides": np.array([f"{k}={v}" for k, v in
                                       OVERRIDES.items()])})
    np.savez_compressed(os.path.join(FIXTURES,
                                     "serve64_visible_jax_golden.npz"), **out)
    print(f"{n_files} files at the factory golden's digests; done in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
