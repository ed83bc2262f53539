#!/usr/bin/env python
"""Write the PyTorch port's training fixture and the JAX reference's
training step on it.

  python tests/make_torch_train_golden.py [--cache DIR]

Writes, under plankassembly_tpu_torch/fixtures/:

- train64.json.gz: 64 info JSONs WITH their `svgs` (the noise
  augmentation corrupts those polylines), built as
  `tests/make_torch_golden.py::make_info` builds the serving fixture —
  `generate_cabinet(seed)` with the default max_planks=20, projected to the
  three views, sent through the SVG render/parse round trip — for seeds
  910000..910063, disjoint from the serving fixture's 900000..900063 and
  from the 0..25999 the shipped checkpoints were trained on;
- train_step_jax_golden.npz: what the JAX package's
  ``jax.value_and_grad(train_step_loss)`` gives on the CPU for
  `checkpoints/gqa_complete_ep221.npz` (float32 parameters) and the first 8
  of those drawings as `LineDataset` packs them without augmentation, with
  dropout 0, in float32 and in bfloat16 compute: the loss, the accuracy,
  and for each parameter leaf (`leaf_names`, JAX's flattening order) the
  gradient's L2 norm and its dot with a probe of the leaf's shape drawn
  as ``np.random.default_rng(leaf_index).standard_normal`` in float32.

This script imports JAX and the JAX package, so it lives with the tests;
the port itself only reads the two files.
"""
import argparse
import dataclasses
import gzip
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

FIXTURES = os.path.join(ROOT, "plankassembly_tpu_torch", "fixtures")
SEEDS = range(910000, 910064)
CKPT = os.path.join(ROOT, "checkpoints", "gqa_complete_ep221.npz")
GOLDEN_ROWS = 8


def make_info(seed: int, workdir: str) -> dict:
    """One drawing through the factory and the SVG round trip, svgs kept."""
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
        "views": views, "types": types_all, "svgs": svgs,
        "coords": np.round(planks / 1280.0, 3).tolist(),
        "attach": attach.tolist(),
    }


def leaf_probe(index: int, shape) -> np.ndarray:
    return np.random.default_rng(index).standard_normal(shape).astype(
        np.float32)


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

    from plankassembly_tpu.data.line_data import LineDataset
    from plankassembly_tpu.data.loader import collate
    from plankassembly_tpu.models.model import ModelDims, train_step_loss
    from tools.predict import load_params_and_config

    with tempfile.TemporaryDirectory() as tmp:
        infos = [make_info(s, tmp) for s in SEEDS]
        for info in infos:
            with open(os.path.join(tmp, f"{info['name']}.json"), "w") as f:
                json.dump(info, f)
        params, cfg = load_params_and_config(CKPT)
        ds = LineDataset(tmp, [f"{i['name']}.json" for i in infos], cfg)
        batch = collate([ds[i] for i in range(GOLDEN_ROWS)])
    os.makedirs(FIXTURES, exist_ok=True)
    with gzip.open(os.path.join(FIXTURES, "train64.json.gz"), "wt") as f:
        json.dump(infos, f, separators=(",", ":"))

    dims = dataclasses.replace(ModelDims.from_config(cfg), dropout=0.0)
    arrays = {k: jnp.asarray(v) for k, v in batch.items()
              if isinstance(v, np.ndarray)}
    paths, leaves = zip(*jax.tree_util.tree_leaves_with_path(params))
    names = ["/".join(p.key for p in path) for path in paths]
    out = {"leaf_names": np.array(names), "names": np.array(batch["name"])}
    for tag, cd in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        def loss_fn(p):
            return train_step_loss(p, arrays, dims,
                                   rng=jax.random.PRNGKey(0),
                                   deterministic=False, compute_dtype=cd,
                                   flash=False)

        (loss, mets), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params)
        g_leaves = jax.tree_util.tree_leaves(grads)
        norms, probes = [], []
        for i, g in enumerate(g_leaves):
            g = np.asarray(g, np.float64)
            norms.append(np.sqrt(np.sum(g * g)))
            probes.append(np.sum(g * leaf_probe(i, g.shape).astype(
                np.float64)))
        out.update({f"loss_{tag}": np.float64(loss),
                    f"accuracy_{tag}": np.float64(mets["accuracy"]),
                    f"grad_norm_{tag}": np.array(norms),
                    f"grad_probe_{tag}": np.array(probes)})
        print(f"{tag}: loss {float(loss):.6f} accuracy "
              f"{float(mets['accuracy']):.6f}", flush=True)
    np.savez_compressed(os.path.join(FIXTURES, "train_step_jax_golden.npz"),
                        **out)
    print(f"done in {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
