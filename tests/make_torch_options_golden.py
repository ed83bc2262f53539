#!/usr/bin/env python
"""Write the JAX reference's outputs on the serving fixture for two decode
options of the flagship checkpoint `checkpoints/gqa_complete_ep221.npz`.

  python tests/make_torch_options_golden.py [--cache DIR] [--only beam|wq]

Writes, under plankassembly_tpu_torch/fixtures/, what the JAX package
returns on the CPU for the 64 drawings of `fixtures/serve64.json.gz` as
one batch at its kv bucket (the request of `serve64_jax_golden.npz`), in
bfloat16 and float32 — samples, attach, num_steps and per-program P/R/F1
against the ground truth:

- serve64_beam4_jax_golden.npz: ``beam_decode(num_beams=4)`` (alpha 0),
  with `beam_scores` as well;
- serve64_wq_jax_golden.npz: ``greedy_decode(cross_impl="xla",
  kv_quant=True, weight_quant=True)``.

Each file records the JAX version (`jax_version`) and the command that
made it (`command`). This script imports JAX and the JAX package, so it
lives with the tests; the port itself only reads the files.
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
CKPT = os.path.join(ROOT, "checkpoints", "gqa_complete_ep221.npz")
BEAM_OUT = os.path.join(FIXTURES, "serve64_beam4_jax_golden.npz")
WQ_OUT = os.path.join(FIXTURES, "serve64_wq_jax_golden.npz")
NUM_BEAMS = 4


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cache", default=None,
                    help="JAX persistent compilation cache directory")
    ap.add_argument("--only", choices=("beam", "wq"), default=None,
                    help="write one of the two files")
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    if args.cache:
        jax.config.update("jax_compilation_cache_dir", args.cache)
    import jax.numpy as jnp

    from plankassembly_tpu.beam import beam_decode
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
    command = "python tests/make_torch_options_golden.py" + (
        f" --only {args.only}" if args.only else "")

    def run(name, out_path, decode):
        out = {"bucket": np.int32(bucket), "gt_samples": gt.astype(np.int32),
               "jax_version": np.array(jax.__version__),
               "command": np.array(command)}
        for dname, cd in (("bf16", jnp.bfloat16), ("f32", jnp.float32)):
            t0 = time.perf_counter()
            res = decode(cd)
            samples = np.asarray(res["samples"])
            prec, rec, f1 = (np.asarray(x) for x in batch_scores(
                jnp.asarray(samples), jnp.asarray(gt)))
            out.update({f"samples_{dname}": samples,
                        f"attach_{dname}": np.asarray(res["attach"]),
                        f"num_steps_{dname}": np.int32(res["num_steps"]),
                        f"prec_{dname}": prec, f"rec_{dname}": rec,
                        f"f1_{dname}": f1})
            if "beam_scores" in res:
                out[f"beam_scores_{dname}"] = np.asarray(res["beam_scores"])
            print(f"{name} {dname}: bucket {bucket} num_steps "
                  f"{int(res['num_steps'])} P {prec.mean():.6f} R "
                  f"{rec.mean():.6f} F1 {f1.mean():.6f} "
                  f"({time.perf_counter() - t0:.0f} s)", flush=True)
        np.savez_compressed(out_path, **out)

    if args.only in (None, "wq"):
        run("weight_quant", WQ_OUT, lambda cd: greedy_decode(
            params, batch, dims, compute_dtype=cd, kv_bucket=bucket,
            kv_quant=True, cross_impl="xla", weight_quant=True))
    if args.only in (None, "beam"):
        run(f"beam{NUM_BEAMS}", BEAM_OUT, lambda cd: beam_decode(
            params, batch, dims, num_beams=NUM_BEAMS, compute_dtype=cd,
            kv_bucket=bucket))


if __name__ == "__main__":
    main()
