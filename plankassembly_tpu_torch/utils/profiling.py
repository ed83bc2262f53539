"""Tracing and step timing (`plankassembly_tpu/utils/profiling.py`):

- `trace_context(log_dir)`: a `torch.profiler` trace of the enclosed
  region (host and, on a GPU, device activity), written under `log_dir`
  as a Chrome trace (open it in Perfetto or chrome://tracing);
- `annotate(name)`: a named region on that timeline
  (`torch.profiler.record_function`);
- `StepTimer`: wall-clock step timing with an EMA.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace_context(log_dir: str, enabled: bool = True):
    """Capture a `torch.profiler` trace of the enclosed region into
    `<log_dir>/trace_<pid>_<time>.json` (the CUDA activity too when CUDA
    is available); yields the profiler, or None when not enabled."""
    if not enabled:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{int(time.time() * 1000)}.json"))


def annotate(name: str):
    """Named sub-region for the profiler timeline."""
    return torch.profiler.record_function(name)


class StepTimer:
    """EMA step timer. Call `tick(result)` once per step. During the first
    `warmup` steps it waits for the device to finish (as the JAX version
    blocks on the result), so that kernel builds and allocator warm-up
    stay out of the average; afterwards it reads the host clock only."""

    def __init__(self, warmup: int = 2, ema: float = 0.9):
        self.warmup = warmup
        self.ema = ema
        self.count = 0
        self.avg_s: float | None = None
        self._last = None

    def tick(self, result=None) -> float | None:
        now = time.perf_counter()
        if self.count < self.warmup and torch.is_tensor(result) \
                and result.device.type == "cuda":
            torch.cuda.synchronize(result.device)
            now = time.perf_counter()
        if self._last is not None and self.count >= self.warmup:
            dt = now - self._last
            self.avg_s = dt if self.avg_s is None else (
                self.ema * self.avg_s + (1 - self.ema) * dt)
        self._last = now
        self.count += 1
        return self.avg_s

    @property
    def steps_per_sec(self) -> float | None:
        return 1.0 / self.avg_s if self.avg_s else None
