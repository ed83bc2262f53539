#!/usr/bin/env python3
"""Where the PyTorch port's serving time goes, on one NVIDIA GPU.

  python3 tools/profile_torch_serve.py [--programs 32] [--dtype bf16]
      [--ckpt checkpoints/gqa_complete_ep221.npz] [--cross-impl persistent]
      [--trace serve_trace.json]

Loads the checkpoint, packs the first `--programs` drawings of the serving
fixture (plankassembly_tpu_torch/fixtures), runs one warm-up decode, then
one `greedy_decode` (encoder + decode loop, int8 cross K/V, by the decode
path `--cross-impl` names; "kernel" and "fused" need an MHA checkpoint such
as checkpoints/mha_complete_ep59.npz) under torch.profiler. Prints the
wall time, the device's busy time (the union of its kernels' and copies'
device intervals: with programmatic dependent launch a kernel starts
before the previous one ends, so their sum would overcount), the device's
idle share of the wall time, the time per decode step, and the kernels
ranked by device time (summed per kernel). Needs CUDA.
"""
import argparse
import gzip
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def busy_union(spans) -> float:
    """Length of the union of (start, end) intervals: the time in which
    at least one of them runs."""
    busy, end = 0.0, -float("inf")
    for a, b in sorted(spans):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--programs", type=int, default=32)
    ap.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    ap.add_argument("--trace", default=None,
                    help="write a chrome trace of the profiled call here")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--ckpt", default=os.path.join(
        ROOT, "checkpoints", "gqa_complete_ep221.npz"))
    ap.add_argument("--cross-impl", default="persistent",
                    choices=("persistent", "xla", "mxu", "kernel", "fused"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_serve: CUDA is not available", file=sys.stderr)
        return 2

    from plankassembly_tpu_torch.checkpoint import load_checkpoint
    from plankassembly_tpu_torch.config import ModelDims
    from plankassembly_tpu_torch.decode import greedy_decode
    from plankassembly_tpu_torch.serving import pack_info_dict

    fixtures = os.path.join(ROOT, "plankassembly_tpu_torch", "fixtures")
    params, cfg = load_checkpoint(args.ckpt, device="cuda")
    dims = ModelDims.from_config(cfg)
    with gzip.open(os.path.join(fixtures, "serve64.json.gz"), "rt") as f:
        infos = json.load(f)[: args.programs]
    bucket = int(np.load(os.path.join(fixtures,
                                      "serve64_jax_golden.npz"))["bucket"])
    packed = [pack_info_dict(i, cfg) for i in infos]
    batch = {k: torch.from_numpy(np.stack([p[k] for p in packed])).cuda()
             for k in packed[0]}
    cd = torch.bfloat16 if args.dtype == "bf16" else torch.float32

    def run():
        out = greedy_decode(params, batch, dims, compute_dtype=cd,
                            kv_bucket=bucket, kv_quant=True,
                            cross_impl=args.cross_impl)
        torch.cuda.synchronize()
        return out

    run()  # warm-up: kernel build and load, cuBLAS set-up
    t0 = time.perf_counter()
    out = run()
    wall_plain = time.perf_counter() - t0

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)),
                    exist_ok=True)
        prof.export_chrome_trace(args.trace)

    # device-side events only: an aten op's own row repeats the device
    # time of the kernels it launched
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and _device_us(e) > 0]
    kernel_us = sum(_device_us(e) for e in kernels)
    busy_us = busy_union((e.time_range.start, e.time_range.end)
                         for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    steps = out["num_steps"]
    print(f"card: {card}")
    print(f"{os.path.basename(args.ckpt)} cross_impl {args.cross_impl} "
          f"programs {args.programs} dtype {args.dtype} bucket {bucket} "
          f"steps {steps}: wall {wall_plain * 1e3:.1f} ms unprofiled, "
          f"{wall * 1e3:.1f} ms profiled; device busy {busy_us / 1e3:.1f} ms "
          f"(union of intervals; kernel times summed {kernel_us / 1e3:.1f} "
          f"ms), idle share {1 - busy_us / 1e3 / (wall * 1e3):.3f}; "
          f"{wall_plain * 1e3 / steps:.3f} ms per step unprofiled")
    print(f"{'kernel':60s} {'calls':>7s} {'device ms':>10s} {'share':>6s} "
          f"{'us/call':>8s}")
    for e in sorted(kernels, key=_device_us, reverse=True)[: args.top]:
        us = _device_us(e)
        print(f"{e.key[:60]:60s} {e.count:7d} {us / 1e3:10.2f} "
              f"{us / kernel_us:6.3f} {us / max(e.count, 1):8.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
