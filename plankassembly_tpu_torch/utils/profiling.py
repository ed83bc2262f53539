"""Step timing (`plankassembly_tpu/utils/profiling.py::StepTimer`)."""
from __future__ import annotations

import time

import torch


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
