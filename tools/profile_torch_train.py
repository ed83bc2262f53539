#!/usr/bin/env python3
"""Where the PyTorch port's training step spends its time, on one NVIDIA
GPU.

  python3 tools/profile_torch_train.py [--steps 2] [--dtype bf16]
                                       [--trace train_trace.json]

One flagship training step: checkpoints/gqa_complete_ep221.npz (GQA, d=512,
6+6 layers) with a fresh Adam state, the 64 drawings of the training
fixture (plankassembly_tpu_torch/fixtures/train64.json.gz) packed by
LineDataset as one batch of 64, dropout 0.2, the fused attention kernels
on. Two warm-up steps, then `--steps` steps unprofiled (ms per step) and
the same number under torch.profiler. Prints the wall time, the device
time summed over the kernels' own events, the device's idle share of the
profiled wall time, and the kernels ranked by device time. Needs CUDA.
"""
import argparse
import gzip
import json
import os
import subprocess
import sys
import tempfile
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    ap.add_argument("--trace", default=None,
                    help="write a chrome trace of the profiled steps here")
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_train: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False

    from plankassembly_tpu_torch.checkpoint import load_training_params
    from plankassembly_tpu_torch.config import (
        ModelDims, config_from_hparams_file,
    )
    from plankassembly_tpu_torch.data.line_data import LineDataset
    from plankassembly_tpu_torch.data.loader import collate
    from plankassembly_tpu_torch.ops import flash_train as FT
    from plankassembly_tpu_torch.train.state import (
        init_state, make_optimizer, make_train_step,
    )

    ckpt = os.path.join(ROOT, "checkpoints", "gqa_complete_ep221.npz")
    cfg = config_from_hparams_file(ckpt[:-4] + ".hparams.yaml")
    dims = ModelDims.from_config(cfg)
    with gzip.open(os.path.join(ROOT, "plankassembly_tpu_torch", "fixtures",
                                "train64.json.gz"), "rt") as f:
        infos = json.load(f)
    with tempfile.TemporaryDirectory() as tmp:
        for info in infos:
            with open(os.path.join(tmp, f"{info['name']}.json"), "w") as f:
                json.dump(info, f)
        ds = LineDataset(tmp, [f"{i['name']}.json" for i in infos], cfg)
        batch = collate([ds[i] for i in range(len(infos))])
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()
             if isinstance(v, np.ndarray)}
    params, _, _ = load_training_params(ckpt)
    state = init_state(params, make_optimizer(cfg.LR), device="cuda")
    cd = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    step = make_train_step(dims, compute_dtype=cd, flash=True)
    rng = torch.Generator("cuda").manual_seed(cfg.seed_everything)

    def run(n):
        for _ in range(n):
            mets = step(state, batch, rng)
        torch.cuda.synchronize()
        return mets

    run(2)  # warm-up: kernel build and load, cuBLAS and allocator set-up
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mets = run(args.steps)
    wall_plain = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    FT.fwd_launches = FT.bwd_launches = 0
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run(args.steps)
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
    busy_us = sum(_device_us(e) for e in kernels)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    n = args.steps
    print(f"card: {card}")
    print(f"train step B={batch['input_value'].shape[0]} L="
          f"{batch['input_value'].shape[1]} {args.dtype}, dropout "
          f"{dims.dropout}, fused attention kernels: "
          f"{wall_plain * 1e3 / n:.1f} ms per step unprofiled "
          f"({n / wall_plain:.3f} steps/s), {wall * 1e3 / n:.1f} ms profiled; "
          f"device busy {busy_us / 1e3 / n:.1f} ms per step (idle share "
          f"{1 - busy_us / 1e3 / (wall * 1e3):.3f}); peak memory "
          f"{peak_gb:.1f} GB; loss {float(mets['loss']):.4f}; launches per "
          f"step fwd {FT.fwd_launches / n:g} bwd {FT.bwd_launches / n:g}")
    print(f"{'kernel':60s} {'calls':>7s} {'device ms':>10s} {'share':>6s} "
          f"{'us/call':>9s}")
    for e in sorted(kernels, key=_device_us, reverse=True)[: args.top]:
        us = _device_us(e)
        print(f"{e.key[:60]:60s} {e.count:7d} {us / 1e3:10.2f} "
              f"{us / busy_us:6.3f} {us / max(e.count, 1):9.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
