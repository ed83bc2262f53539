"""Offline decode: jobs of pre-packed drawings in length-sorted batches
through `decode.greedy_decode`, the call that `predict`, `Trainer.test`
and the robustness sweep make (kv bucket from `pick_kv_bucket`, int8
cross K/V, `cross_impl="auto"`, bfloat16), each batch copied back and
post-processed by `serving.postprocess_prediction`.

Traffic keys: batch (rows a call), job (drawings a job: the pool, each
drawing equally often, in an order drawn from the seed, packed at set-up
by `serving.pack_info_dict` as the sample cache holds them and sorted by
real tokens as `predict` sorts them). The
window runs the job's batches over and over, closed loop.
"""
from __future__ import annotations

import time

import numpy as np

from bench_port.harness import check as C
from bench_port.harness import pool as P
from bench_port.harness.layers import wrap_decode


def run(ctx) -> None:
    import torch
    from plankassembly_tpu_torch import decode as D
    from plankassembly_tpu_torch.checkpoint import load_checkpoint
    from plankassembly_tpu_torch.config import ModelDims
    from plankassembly_tpu_torch.serving import (
        pack_info_dict, postprocess_prediction,
    )

    tr, conf = ctx.traffic, ctx.config
    params, cfg = load_checkpoint(ctx.path(conf["checkpoint"]),
                                  ctx.path(conf["hparams"]),
                                  device=ctx.device)
    dims = ModelDims.from_config(cfg)
    ctx.check_program_config(cfg)
    bodies = P.requests()
    order = P.balanced_order(len(bodies), tr["job"], ctx.seed)
    packed = [pack_info_dict(bodies[i], cfg) for i in order]
    real = [int((~p["input_mask"]).sum()) for p in packed]
    rows = sorted(range(len(packed)), key=real.__getitem__)
    B = tr["batch"]
    batches = [rows[lo:lo + B] for lo in range(0, len(rows), B)]
    host = [{k: np.stack([packed[j][k] for j in b]) for k in packed[0]}
            for b in batches]

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

    for bi in range(len(batches)):      # every shape of the job, once
        call(bi)
    ctx.sync()
    ctx.mark_setup()
    wrap_decode(ctx.trace, D)
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

