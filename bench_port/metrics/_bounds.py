"""Least times on one H100 and the table of peaks.

`decode_ms` is `chip_smoke.py::decode_bound` (copied, and made to take
counts in place of tensors); `encoder_ms` counts the encoder the same
way, its attention as `chip_smoke.py::flash_case` counts it (4 * Dh * H
operations per real (query, key) pair). A bound is the larger of the
bytes over the HBM rate and the operations over the peak: each input
byte is read once, each output byte written once, and only the real
tokens and the steps these inputs need are counted, so a share of it
cannot pass 100%.
"""
from __future__ import annotations

import math

from bench_port.metrics._flops import (
    decoder_layer_flops, encoder_flops, head_flops,
)

# NVIDIA H100 SXM data sheet, dense: bf16 989 TFLOP/s, float32 outside the
# tensor cores 67 TFLOP/s, HBM3 3.35 TB/s (at the 700 W power limit)
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
HBM_BYTES_PER_S = 3.35e12


def _ms(nbytes: float, ops: list[tuple[float, float]]) -> float:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = sum(n / peak for n, peak in ops)
    return max(t_bytes, t_ops) * 1e3


def decode_ms(d: dict, rows: int, width: int, real: int, steps: int) -> float:
    """persistent_greedy_decode on `rows` rows of memory `width` wide with
    `real` real memory rows in all, run for `steps` steps. Bytes: the real
    memory rows (f32) and the mask read once, each parameter once at the
    dtype the kernels read it (the decoder's products in bf16; norms,
    heads and embeddings in f32), the outputs written once. Operations:
    the cross K/V projection of the real rows, each step's products,
    self-attention over the keys so far, cross-attention over the real
    keys (masked keys add exactly 0), the heads in f32."""
    D, Dkv, F, V, S, Ld = (d["D"], d["Dkv"], d["F"], d["V"], d["S"],
                           d["Ld"])
    attn = 2 * (2 * D * D + 2 * D * Dkv) + 2 * (2 * D + 2 * Dkv)
    ffn = 2 * D * F + F + D
    nparam = Ld * (attn + ffn) * 2
    nparam += 4 * (Ld * 3 * 2 * D + 2 * D)                   # norms
    nparam += 4 * (D * V + V + D * D + D + D + 1)            # heads
    nparam += 4 * D * (V + d["dof"] + math.ceil(S / d["dof"]))  # embeds
    nbytes = real * D * 4 + rows * width + nparam + 2 * rows * S * 4
    low = 2.0 * real * D * 2 * Dkv * Ld
    high = 0.0
    for t in range(steps):
        low += rows * Ld * (decoder_layer_flops(d) + 4.0 * D * (t + 1))
        low += Ld * 4.0 * D * real
        high += rows * head_flops(d, t)
    return _ms(nbytes, [(low, PEAK_BF16), (high, PEAK_F32)])


def encoder_ms(d: dict, lengths: list[int], streams: int) -> float:
    """`models/model.py::encode` over rows of these real lengths. Bytes:
    the ids of each real token's `streams` input streams (int64) and its
    embedding rows (f32), the weights once (products in bf16, biases and
    norms in f32), the memory rows written (f32). Operations: the
    encoder's products and attention on real tokens, in bf16."""
    D, Dkv, F, Le = d["D"], d["Dkv"], d["F"], d["Le"]
    real = sum(lengths)
    weights = Le * (2 * D * D + 2 * D * Dkv + 2 * D * F) * 2
    weights += 4 * (Le * (2 * D + 2 * Dkv + F + D + 4 * D) + 2 * D)
    nbytes = real * streams * (8 + 4 * D) + weights + real * D * 4
    ops = sum(encoder_flops(d, n) for n in lengths)
    return _ms(nbytes, [(ops, PEAK_BF16)])
