#!/usr/bin/env python
"""Write the JAX reference's outputs on the serving fixture for the MHA
checkpoint `checkpoints/mha_complete_ep59.npz`.

  python tests/make_torch_mha_golden.py [--cache DIR] [--no-fused]

Writes plankassembly_tpu_torch/fixtures/serve64_mha_jax_golden.npz: what
the JAX package returns on the CPU for the 64 drawings of
`fixtures/serve64.json.gz` with ep59, at the batch's kv bucket, in
bfloat16 and float32 — samples, attach, num_steps and per-program P/R/F1
against the ground truth — for two decode paths:

- ``greedy_decode(kv_quant=True, cross_impl="xla")`` (key prefix `xla_`),
  the reference of the port's `cross_impl="kernel"`;
- ``greedy_decode(kv_quant=True, cross_impl="mxu")`` (prefix `mxu_`,
  int8 self K/V as well), the reference of `cross_impl="fused"`.

Unless --no-fused, it also decodes the first FUSED_ROWS drawings in float32
through the Pallas fused decoder layer in interpret mode
(``cross_impl="fused-interpret"``, prefix `fused_f32_`), the algorithm
the port's `fused` path implements.

This script imports JAX and the JAX package, so it lives with the tests;
the port itself only reads the file.
"""
import argparse
import gzip
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

FIXTURES = os.path.join(ROOT, "plankassembly_tpu_torch", "fixtures")
CKPT = os.path.join(ROOT, "checkpoints", "mha_complete_ep59.npz")
OUT = os.path.join(FIXTURES, "serve64_mha_jax_golden.npz")
FUSED_ROWS = 4


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cache", default=None,
                    help="JAX persistent compilation cache directory")
    ap.add_argument("--no-fused", action="store_true",
                    help="skip the fused-interpret subset")
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    if args.cache:
        jax.config.update("jax_compilation_cache_dir", args.cache)
    import jax.numpy as jnp

    from plankassembly_tpu.data.packing import pack_output_sequence
    from plankassembly_tpu.decode import greedy_decode, pick_kv_bucket
    from plankassembly_tpu.metrics import batch_scores
    from plankassembly_tpu.models.model import ModelDims
    from plankassembly_tpu.serving import pack_info_dict
    from tools.predict import load_params_and_config

    with gzip.open(os.path.join(FIXTURES, "serve64.json.gz"), "rt") as f:
        infos = json.load(f)
    params, cfg = load_params_and_config(CKPT)
    dims = ModelDims.from_config(cfg)
    packed = [pack_info_dict(info, cfg) for info in infos]
    batch = {k: jnp.asarray(np.stack([p[k] for p in packed]))
             for k in packed[0]}
    bucket = pick_kv_bucket(batch["input_mask"])
    gt = np.stack([pack_output_sequence(
        np.array(info["coords"]).flatten(), np.array(info["attach"]).flatten(),
        cfg.DATA, cfg.TOKEN)["output_value"] for info in infos])

    out = {"bucket": np.int32(bucket), "gt_samples": gt.astype(np.int32)}

    def record(prefix, res, gt_rows):
        samples = np.asarray(res["samples"])
        prec, rec, f1 = (np.asarray(x) for x in batch_scores(
            jnp.asarray(samples), jnp.asarray(gt_rows)))
        out.update({f"{prefix}samples": samples,
                    f"{prefix}attach": np.asarray(res["attach"]),
                    f"{prefix}num_steps": np.int32(res["num_steps"]),
                    f"{prefix}prec": prec, f"{prefix}rec": rec,
                    f"{prefix}f1": f1})
        print(f"{prefix}: bucket {bucket} num_steps {int(res['num_steps'])} "
              f"P {prec.mean():.6f} R {rec.mean():.6f} F1 {f1.mean():.6f}",
              flush=True)

    for impl in ("xla", "mxu"):
        for name, cd in (("bf16", jnp.bfloat16), ("f32", jnp.float32)):
            t0 = time.perf_counter()
            res = greedy_decode(params, batch, dims, compute_dtype=cd,
                                kv_bucket=bucket, kv_quant=True,
                                cross_impl=impl, early_exit=True)
            record(f"{impl}_{name}_", res, gt)
            print(f"  {time.perf_counter() - t0:.1f} s", flush=True)
    if not args.no_fused:
        sub = {k: v[:FUSED_ROWS] for k, v in batch.items()}
        t0 = time.perf_counter()
        res = greedy_decode(params, sub, dims, compute_dtype=jnp.float32,
                            kv_bucket=bucket, kv_quant=True,
                            cross_impl="fused-interpret", early_exit=True)
        record("fused_f32_", res, gt[:FUSED_ROWS])
        print(f"  {time.perf_counter() - t0:.1f} s", flush=True)
    np.savez_compressed(OUT, **out)


if __name__ == "__main__":
    main()
