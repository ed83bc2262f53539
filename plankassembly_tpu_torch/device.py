"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: the
default device is ``"cuda"``, and when CUDA is absent they raise instead of
carrying on quietly on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; the port runs on the GPU by default — "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    return dev
