"""Offline decode: jobs of pre-packed drawings in length-sorted batches
through `decode.greedy_decode`, the call that `predict`, `Trainer.test`
and the robustness sweep make (kv bucket from `pick_kv_bucket`, int8
cross K/V, `cross_impl="auto"`, bfloat16), each batch copied back and
post-processed by `serving.postprocess_prediction`.

Traffic keys: batch (rows a call), job (drawings a job: the pool, each
drawing equally often, in an order drawn from the seed, packed at set-up
by `serving.pack_info_dict` as the sample cache holds them and sorted by
real tokens as `predict` sorts them). Set-up warms each shape of the job
(rows and kv bucket) with its first batch, and marks its parts (`load`,
`pack`; `warm` the rest). The window runs the job's batches over and
over, closed loop.
"""
from __future__ import annotations

import time

import numpy as np

from bench_port.harness import check as C
from bench_port.harness import pool as P
from bench_port.harness.layers import wrap_decode


def batches_of(real: list[int], batch: int) -> list[list[int]]:
    """The job's drawings (`real`: each one's real tokens) sorted by
    length, as `predict` sorts them, in batches of `batch` rows."""
    rows = sorted(range(len(real)), key=real.__getitem__)
    return [rows[lo:lo + batch] for lo in range(0, len(rows), batch)]


def first_of_each_shape(shapes: list) -> list[int]:
    """Index of the first batch of each distinct shape, in job order."""
    seen = {}
    for i, shape in enumerate(shapes):
        seen.setdefault(shape, i)
    return sorted(seen.values())


def _launches(PD) -> dict:
    return dict(getattr(PD, "launches_by_route", {}))


def _since(PD, before: dict) -> dict:
    return {route: n - before.get(route, 0)
            for route, n in _launches(PD).items() if n > before.get(route, 0)}


def run(ctx) -> None:
    import torch
    from plankassembly_tpu_torch import decode as D
    from plankassembly_tpu_torch.checkpoint import load_checkpoint
    from plankassembly_tpu_torch.config import ModelDims
    from plankassembly_tpu_torch.ops import persistent_decode as PD
    from plankassembly_tpu_torch.serving import (
        pack_info_dict, postprocess_prediction,
    )

    tr, conf = ctx.traffic, ctx.config
    params, cfg = load_checkpoint(ctx.path(conf["checkpoint"]),
                                  ctx.path(conf["hparams"]),
                                  device=ctx.device)
    dims = ModelDims.from_config(cfg)
    ctx.check_program_config(cfg)
    ctx.mark("load")
    bodies = P.requests(conf)
    order = P.balanced_order(len(bodies), tr["job"], ctx.seed)
    packed = [pack_info_dict(bodies[i], cfg) for i in order]
    real = [int((~p["input_mask"]).sum()) for p in packed]
    batches = batches_of(real, tr["batch"])
    host = [{k: np.stack([packed[j][k] for j in b]) for k in packed[0]}
            for b in batches]
    ctx.mark("pack")

    def call(bi):
        inputs = {k: torch.from_numpy(v).to(ctx.device)
                  for k, v in host[bi].items()}
        out = D.greedy_decode(params, inputs, dims,
                              compute_dtype=torch.bfloat16,
                              kv_bucket=D.pick_kv_bucket(
                                  inputs["input_mask"]),
                              kv_quant=True, cross_impl="auto")
        s, a = out["samples"].cpu().numpy(), out["attach"].cpu().numpy()
        return s, a, [postprocess_prediction(s[i], a[i], dims)
                      for i in range(len(s))]

    shapes = [(len(b), D.pick_kv_bucket(h["input_mask"]))
              for b, h in zip(batches, host)]
    # kernel 2's launches by route (the program's counter, where it has
    # one) in each shape's first call and in the window
    routes = {"warm_up": {}}
    for bi in first_of_each_shape(shapes):
        before = _launches(PD)
        call(bi)
        routes["warm_up"]["x".join(map(str, shapes[bi]))] = \
            _since(PD, before)
    ctx.sync()
    ctx.mark_setup()
    wrap_decode(ctx.trace, D)
    before = _launches(PD)
    ctx.trace.start()
    done = []
    t0 = time.monotonic()
    deadline = t0 + ctx.seconds
    k = 0
    while True:
        bi = k % len(batches)
        done.append((bi,) + call(bi))
        k += 1
        if time.monotonic() >= deadline:
            break
    ctx.window_s = time.monotonic() - t0
    ctx.trace.stop()
    routes["window"] = _since(PD, before)
    ctx.routes = routes
    ctx.read_memory_peak()
    del params
    end = conf["TOKEN"]["END"]
    flat = [(bi, i, s, a, p) for bi, s, a, p in done for i in range(len(s))]
    ctx.attempted = len(flat)
    ctx.failed = 0
    lengths = [C.served_length(s[i], end) for _, i, s, _, _ in flat]
    ctx.programs = [(real[batches[bi][i]], n)
                    for (bi, i, _, _, _), n in zip(flat, lengths)]
    ctx.items = []
    keys = [int(order[batches[bi][i]]) for bi, i, _, _, _ in flat]
    for j in C.sample_indices(keys, lengths, ctx.seed):
        bi, i, s, a, p = flat[j]
        src = batches[bi][i]
        ctx.items.append({"body": bodies[order[src]], "packed": packed[src],
                          "tokens": s[i], "attach": a[i],
                          "answer": (p[i][0], p[i][1])})

