"""Token contract: coordinate quantization and special tokens (a copy of
`plankassembly_tpu/tokens.py`).

- Coordinates live in [-1, 1] and quantize to ``2**num_bits`` integer bins.
- ``END = 2**num_bits`` (512) terminates a sequence; ``PAD = END + 1``.
- Output labels >= VOCAB_SIZE are attachment pointers: ``VOCAB_SIZE + j``
  means "copy output token j".
"""
from __future__ import annotations

import numpy as np

NUM_BITS = 9
NUM_BINS = 2**NUM_BITS
END = NUM_BINS
PAD = NUM_BINS + 1
VOCAB_SIZE = NUM_BINS + 2


def quantize_values(verts: np.ndarray, n_bits: int = NUM_BITS) -> np.ndarray:
    """Map coords in [-1, 1] to integers in [0, 2**n_bits - 1], truncating
    toward zero like the reference's int cast."""
    range_quantize = 2**n_bits - 1
    verts = np.asarray(verts, dtype=np.float64)
    quantized = (verts + 1.0) * range_quantize / 2.0
    return quantized.astype(np.int64)


def dequantize_values(quantized: np.ndarray, n_bits: int = NUM_BITS) -> np.ndarray:
    """Map integers in [0, 2**n_bits - 1] back to [-1, 1]."""
    range_quantize = 2**n_bits - 1
    quantized = np.asarray(quantized, dtype=np.float64)
    return (quantized * 2.0 / range_quantize - 1.0).astype(np.float64)
