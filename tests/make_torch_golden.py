#!/usr/bin/env python
"""Write the PyTorch port's serving fixture and the JAX reference's
outputs on it.

  python tests/make_torch_golden.py [--cache DIR]

Writes, under plankassembly_tpu_torch/fixtures/:

- serve64.json.gz: 64 info JSONs (lines, views, types, coords, attach; no
  svgs) built the way `tests/tiny.py::write_tiny_dataset` builds them —
  `generate_cabinet(seed)` with the default max_planks=20, projected to
  the three views and sent through the SVG render/parse round trip — for
  seeds 900000..900063, outside the 0..25999 range the shipped checkpoints
  were trained on;
- serve64_jax_golden.npz: what the JAX package returns for them with
  `checkpoints/gqa_complete_ep221.npz` on the CPU:
  ``greedy_decode(kv_quant=True, self_quant=False, cross_impl="xla")`` at
  the batch's kv bucket, once in bfloat16 and once in float32 — samples,
  attach, num_steps and per-program P/R/F1 against the ground truth.

This script imports JAX and the JAX package, so it lives with the tests;
the port itself only reads the two files.
"""
import argparse
import gzip
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

FIXTURES = os.path.join(ROOT, "plankassembly_tpu_torch", "fixtures")
SEEDS = range(900000, 900064)
CKPT = os.path.join(ROOT, "checkpoints", "gqa_complete_ep221.npz")


def make_info(seed: int, workdir: str) -> dict:
    """One drawing through the factory and the SVG round trip, as
    `tests/tiny.py::write_tiny_dataset` does (without the svgs key)."""
    from plankassembly_tpu.data import geometry as geo
    from plankassembly_tpu.factory.projection import (
        VIEWS, postprocess_complete, project_boxes,
    )
    from plankassembly_tpu.factory.synthetic import generate_cabinet
    from plankassembly_tpu.io.svg import parse_svg, render_svg

    planks, attach = generate_cabinet(seed)
    boxes = planks[1:] / 1280.0
    svgs, views, types_all = [], [], []
    for v_i, view in enumerate(VIEWS):
        lines, types = project_boxes(boxes, view)
        lines, types = postprocess_complete(lines, types)
        path = os.path.join(workdir, f"tmp_{view}.svg")
        render_svg(path, lines, types)
        plines, ptypes = parse_svg(path)
        svgs.extend(geo.to_geojson(l) for l in plines)
        types_all.extend(ptypes)
        views.extend([v_i] * len(plines))
    return {
        "name": f"syn{seed}",
        "lines": [geo.bounds(geo.from_geojson(s)).tolist() for s in svgs],
        "views": views, "types": types_all,
        "coords": np.round(planks / 1280.0, 3).tolist(),
        "attach": attach.tolist(),
    }


def make_infos(seeds=SEEDS) -> list:
    with tempfile.TemporaryDirectory() as tmp:
        return [make_info(s, tmp) for s in seeds]


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

    infos = make_infos()
    os.makedirs(FIXTURES, exist_ok=True)
    with gzip.open(os.path.join(FIXTURES, "serve64.json.gz"), "wt") as f:
        json.dump(infos, f, separators=(",", ":"))

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
    for name, cd in (("bf16", jnp.bfloat16), ("f32", jnp.float32)):
        res = greedy_decode(params, batch, dims, compute_dtype=cd,
                            kv_bucket=bucket, kv_quant=True, self_quant=False,
                            cross_impl="xla", early_exit=True)
        samples = np.asarray(res["samples"])
        prec, rec, f1 = (np.asarray(x) for x in batch_scores(
            jnp.asarray(samples), jnp.asarray(gt)))
        out.update({f"samples_{name}": samples,
                    f"attach_{name}": np.asarray(res["attach"]),
                    f"num_steps_{name}": np.int32(res["num_steps"]),
                    f"prec_{name}": prec, f"rec_{name}": rec,
                    f"f1_{name}": f1})
        print(f"{name}: bucket {bucket} num_steps {int(res['num_steps'])} "
              f"P {prec.mean():.6f} R {rec.mean():.6f} F1 {f1.mean():.6f}",
              flush=True)
    np.savez_compressed(os.path.join(FIXTURES, "serve64_jax_golden.npz"),
                        **out)


if __name__ == "__main__":
    main()
