#!/usr/bin/env python
"""Write the JAX reference's sideface serving outputs on the serving
fixture, for the PyTorch port's checks on the card.

  python tests/make_torch_sideface_golden.py [--cache DIR]

The 64 drawings of plankassembly_tpu_torch/fixtures/serve64.json.gz become
sideface requests: each request's `svgs` are the two-point linestrings of
its `lines` (the fixture's lines are axis-aligned two-point segments, so
nothing is lost). They are packed by the JAX package's
`pack_info_dict(with_type=False)` (side-face extraction, no line-type
stream) and decoded with `checkpoints/gqa_sideface_ep119.npz` on the CPU,
as requests of 8, 24 and 32 drawings in that order, each at its own kv
bucket: ``greedy_decode(kv_quant=True, self_quant=False,
cross_impl="xla")``, once in bfloat16 and once in float32.

Writes plankassembly_tpu_torch/fixtures/serve64_sideface_jax_golden.npz:
the requests' sizes and buckets, the ground truth, the packed face counts,
and per dtype the samples, attach, each request's num_steps and the
per-program P/R/F1.

This script imports JAX and the JAX package, so it lives with the tests;
the port only reads the file.
"""
import argparse
import gzip
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

FIXTURES = os.path.join(ROOT, "plankassembly_tpu_torch", "fixtures")
CKPT = os.path.join(ROOT, "checkpoints", "gqa_sideface_ep119.npz")
REQUESTS = (8, 24, 32)


def sideface_requests(infos: list) -> list:
    """The drawings as sideface requests: `svgs` from their `lines`."""
    out = []
    for info in infos:
        svgs = [json.dumps({"type": "LineString",
                            "coordinates": [[a, b], [c, d]]},
                           separators=(",", ":"))
                for a, b, c, d in info["lines"]]
        out.append({**info, "svgs": svgs})
    return out


def load_requests() -> list:
    with gzip.open(os.path.join(FIXTURES, "serve64.json.gz"), "rt") as f:
        return sideface_requests(json.load(f))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cache", default=None,
                    help="JAX persistent compilation cache directory")
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

    infos = load_requests()
    assert len(infos) == sum(REQUESTS)
    params, cfg = load_params_and_config(CKPT)
    dims = ModelDims.from_config(cfg)
    packed = [pack_info_dict(info, cfg, with_type=False) for info in infos]
    assert "input_type" not in packed[0]
    gt = np.stack([pack_output_sequence(
        np.array(info["coords"]).flatten(), np.array(info["attach"]).flatten(),
        cfg.DATA, cfg.TOKEN)["output_value"] for info in infos])
    faces = np.array([(int((~p["input_mask"]).sum()) - 1)
                      // cfg.DATA.NUM_INPUT_DOF for p in packed], np.int32)

    starts = np.cumsum((0,) + REQUESTS[:-1])
    buckets = []
    for first, n in zip(starts, REQUESTS):
        mask = np.stack([p["input_mask"] for p in packed[first:first + n]])
        buckets.append(pick_kv_bucket(mask))
    out = {"requests": np.array(REQUESTS, np.int32),
           "buckets": np.array(buckets, np.int32),
           "gt_samples": gt.astype(np.int32), "face_counts": faces}
    for name, cd in (("bf16", jnp.bfloat16), ("f32", jnp.float32)):
        samples, attach, steps = [], [], []
        for first, n, bucket in zip(starts, REQUESTS, buckets):
            batch = {k: jnp.asarray(np.stack([p[k] for p in
                                              packed[first:first + n]]))
                     for k in packed[0]}
            res = greedy_decode(params, batch, dims, compute_dtype=cd,
                                kv_bucket=bucket, kv_quant=True,
                                self_quant=False, cross_impl="xla",
                                early_exit=True)
            samples.append(np.asarray(res["samples"]))
            attach.append(np.asarray(res["attach"]))
            steps.append(int(res["num_steps"]))
        samples = np.concatenate(samples)
        prec, rec, f1 = (np.asarray(x) for x in batch_scores(
            jnp.asarray(samples), jnp.asarray(gt)))
        out.update({f"samples_{name}": samples,
                    f"attach_{name}": np.concatenate(attach),
                    f"num_steps_{name}": np.array(steps, np.int32),
                    f"prec_{name}": prec, f"rec_{name}": rec,
                    f"f1_{name}": f1})
        print(f"{name}: buckets {buckets} num_steps {steps} faces "
              f"{faces.min()}..{faces.max()} P {prec.mean():.6f} R "
              f"{rec.mean():.6f} F1 {f1.mean():.6f}", flush=True)
    np.savez_compressed(
        os.path.join(FIXTURES, "serve64_sideface_jax_golden.npz"), **out)


if __name__ == "__main__":
    main()
