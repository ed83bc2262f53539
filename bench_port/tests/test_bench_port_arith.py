"""Operation counts and least times against hand counts at one small
shape, and the union of intervals."""
from __future__ import annotations

import pytest

from bench_port.metrics import _bounds as B
from bench_port.metrics import _flops as F
from bench_port.metrics import _intervals as I

# D=8, H=2 (Dh 4), kvH=1 (Dkv 4), F=16, 1+1 layers, V=10, S=12, dof 6
D = {"D": 8, "H": 2, "Dh": 4, "Dkv": 4, "F": 16, "Le": 1, "Ld": 1,
     "V": 10, "S": 12, "dof": 6}


def test_encoder_flops_by_hand():
    # per token: q 8x8, k 8x4, v 8x4, o 8x8, ffn 8x16 + 16x8: 448 MACs
    # = 896 ops; attention 4 * D per (query, key): 3 tokens -> 9 pairs
    assert F.encoder_flops(D, 3) == 3 * 896 + 4 * 8 * 9


def test_decoder_flops_by_hand():
    # layer: self q/k/v/o 64+32+32+64, cross q/o 64+64, ffn 256: 576 MACs
    assert F.decoder_layer_flops(D) == 2 * 576
    # heads at t: vocab 8x10 + pointer 8x8 + switch 8x1 = 152 MACs, and
    # t pointer logits of width 8
    assert F.head_flops(D, 2) == 2 * 152 + 2 * 8 * 2
    # n=3 real memory tokens, 2 steps: cross K/V 3 x (8x4 + 8x4) MACs
    kv = 2 * 3 * 64
    step = [2 * 576 + 4 * 8 * (t + 1) + 4 * 8 * 3 + 2 * 152 + 16 * t
            for t in range(2)]
    assert F.decoder_flops(D, 3, 2) == kv + sum(step)
    assert F.program_flops(D, 3, 2) == F.encoder_flops(D, 3) + kv + sum(step)


def test_decode_bound_by_hand():
    rows, width, real, steps = 2, 5, 6, 2
    low = 2 * real * 8 * 2 * 4
    for t in range(steps):
        low += rows * (2 * 576 + 4 * 8 * (t + 1)) + 4 * 8 * real
    high = sum(rows * F.head_flops(D, t) for t in range(steps))
    attn = 2 * (2 * 64 + 2 * 32) + 2 * (16 + 8)
    ffn = 2 * 8 * 16 + 16 + 8
    params = (attn + ffn) * 2 + 4 * (3 * 2 * 8 + 16) \
        + 4 * (80 + 10 + 64 + 8 + 8 + 1) + 4 * 8 * (10 + 6 + 2)
    nbytes = real * 8 * 4 + rows * width + params + 2 * rows * 12 * 4
    want = max(nbytes / B.HBM_BYTES_PER_S,
               low / B.PEAK_BF16 + high / B.PEAK_F32) * 1e3
    assert B.decode_ms(D, rows, width, real, steps) == pytest.approx(want)


def test_encoder_bound_by_hand():
    ops = F.encoder_flops(D, 3) + F.encoder_flops(D, 2)
    weights = (2 * 64 + 2 * 32 + 2 * 128) * 2 \
        + 4 * ((16 + 8 + 16 + 8 + 32) + 16)
    nbytes = 5 * 4 * (8 + 32) + weights + 5 * 8 * 4
    want = max(nbytes / B.HBM_BYTES_PER_S, ops / B.PEAK_BF16) * 1e3
    assert B.encoder_ms(D, [3, 2], 4) == pytest.approx(want)


def test_union_and_gaps():
    spans = [(0, 2), (1, 3), (5, 6), (5.5, 7)]
    assert I.merge(spans) == [(0, 3), (5, 7)]
    assert I.busy(spans) == 5
    assert I.busy(spans, 1, 6) == 3
    assert I.gaps(spans, -1, 8) == [(-1, 0), (3, 5), (7, 8)]
