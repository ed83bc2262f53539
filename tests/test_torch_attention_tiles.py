"""The numerics of the tensor-core route of the port's attention kernels
(`plankassembly_tpu_torch/csrc/attn_mma.cuh`, `attention.cu`,
`flash_train.cu`, their bf16 form), emulated in PyTorch on the CPU and
held against the plain versions with the bounds `chip_smoke.py` holds the
kernels to on the card.

The emulation walks the kernels' tiles: query (or key) blocks of 64 rows,
key (or query) tiles of 64 staged with the rows past the end read as zero,
an online softmax rescaled once per key tile, key tiles skipped past a
row's key end, products of bf16 operands accumulated in float32, and every
float32 weight (P in the forward, w and ds in the backward) multiplied as
its two bf16 halves, hi = bf16(x) and lo = bf16(x - hi). The dropout keep
bit of each element is computed where the kernel computes it: at the
(row, column) that the m16n8k16 accumulator layout gives the lane's
register, and placed there.
"""
import math

import numpy as np
import pytest
import torch

from plankassembly_tpu_torch.ops import flash_train as FT
from plankassembly_tpu_torch.ops.attention import flash_attention_reference

TILE = 64
NEG_INF = -1e9
# chip_smoke.py's FLASH_TOL for bf16: the largest |kernel - plain| over the
# output, both rounded to bf16 (an output of O(1) is one bf16 ulp, 2^-8
# of it, from a rounding that went the other way)
FLASH_TOL_BF16 = 2e-2
# chip_smoke.py's TRAIN_KERNEL_TOL for bf16, against the plain version in
# float32 on the same (bf16) inputs: |got - ref| <= 2^-7 |ref| + 1e-4 (max
# |ref| of the row) + 1e-5 max |ref|. The kernel rounds its float32 result
# to bf16 once, at most 2^-8 |ref|; one ulp leaves room for float32 order.
TRAIN_TOL_BF16 = (2.0 ** -7, 1e-4)
SEED = 1234567


# -------------------------------------------- the m16n8k16 accumulator map
def frag_row(lane, i):
    """Row, within its warp's 16, of accumulator element i of a lane
    (`frag_row` in attn_mma.cuh)."""
    return (lane >> 2) + (i >> 1) * 8


def frag_col(lane, i):
    """Column, within its 16 x 8 product, of accumulator element i of a
    lane (`frag_col` in attn_mma.cuh)."""
    return ((lane & 3) << 1) + (i & 1)


def fragment_map():
    """(row, column) in a block's 64 x 64 tile of every accumulator element
    (warp w, lane, n-tile j, element i): warp w owns rows 16w..16w+15, and
    its j-th 16 x 8 product columns 8j..8j+7."""
    w = torch.arange(4).view(4, 1, 1, 1)
    lane = torch.arange(32).view(1, 32, 1, 1)
    j = torch.arange(8).view(1, 1, 8, 1)
    i = torch.arange(4).view(1, 1, 1, 4)
    rows = (16 * w + frag_row(lane, i)).expand(4, 32, 8, 4).reshape(-1)
    cols = (8 * j + frag_col(lane, i)).expand(4, 32, 8, 4).reshape(-1)
    return rows, cols


FRAG_ROWS, FRAG_COLS = fragment_map()


def keep_tile(row0, col0, rows_are_queries, b, h, seed, rate, block_q):
    """The keep bits of one 64 x 64 tile (rows from global index row0,
    columns from col0), each computed from the (row, column) of the
    accumulator element that holds it and placed there. Rows are query
    rows and columns keys in the forward and dQ, and the other way round
    in dK/dV."""
    rows, cols = row0 + FRAG_ROWS, col0 + FRAG_COLS
    qi, key = (rows, cols) if rows_are_queries else (cols, rows)
    cell = FT.cell_seed(seed, b, h, qi // block_q)
    bits = FT._hash(FT._row_col(qi % block_q, key), cell) \
        >= FT.dropout_threshold(rate)
    tile = torch.zeros((TILE, TILE), dtype=torch.bool)
    tile[FRAG_ROWS, FRAG_COLS] = bits
    return tile


# ------------------------------------------------------------- emulation
def split(x):
    """The two bf16 halves of a float32 weight."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def weights_times(w, b, lo_half):
    """w (f32 weights) @ b (bf16 values) as the kernel multiplies them:
    hi @ b + lo @ b in float32, or hi @ b alone without the low half."""
    hi, lo = split(w)
    out = hi @ b
    return out + lo @ b if lo_half else out


def rows_of(x, r0, L):
    """Rows [r0, r0 + 64) of x (..., L, D), zero past L (a staged tile)."""
    out = torch.zeros(x.shape[:-2] + (TILE, x.shape[-1]))
    n = max(0, min(TILE, L - r0))
    out[..., :n, :] = x[..., r0:r0 + n, :]
    return out


def key_end(length, Lk, Lq, row0, causal):
    if length <= 0:
        return Lk
    kend = min(Lk, length)
    return min(kend, Lq, row0 + TILE) if causal else kend


def emulate_forward(q, k, v, lengths, causal, Lk_pad, rate=0.0, seed=SEED,
                    lo_half=True):
    """The forward tile routine (`fwd_tile`): (o, m, l) in float32."""
    B, H, Lq, Dh = q.shape
    Lk, G = k.shape[2], H // k.shape[1]
    scale = 1.0 / math.sqrt(Dh)
    block_q = FT.plan(Lq, Lk)[0]
    o = torch.zeros(B, H, Lq, Dh)
    m_out, l_out = torch.zeros(B, H, Lq), torch.zeros(B, H, Lq)
    for b in range(B):
        length = int(lengths[b])
        kb = k[b].repeat_interleave(G, 0)
        vb = v[b].repeat_interleave(G, 0)
        for q0 in range(0, Lq, TILE):
            rows = torch.arange(q0, q0 + TILE)
            qt = rows_of(q[b], q0, Lq)
            kend = key_end(length, Lk, Lq, q0, causal)
            m = torch.full((H, TILE), -1e30)
            l = torch.zeros(H, TILE)
            acc = torch.zeros(H, TILE, Dh)
            for k0 in range(0, kend, TILE):
                keys = torch.arange(k0, k0 + TILE)
                kt, vt = rows_of(kb, k0, Lk), rows_of(vb, k0, Lk)
                s = qt @ kt.transpose(1, 2)
                valid = keys[None, :] < length
                if causal:
                    valid = valid & (keys[None, :] <= rows[:, None])
                x = torch.where(valid, s * scale, NEG_INF)
                x = torch.where(keys < kend, x, -math.inf)
                mnew = torch.maximum(m, x.amax(-1))
                alpha = torch.exp(m - mnew)
                l, acc = l * alpha, acc * alpha[..., None]
                e = torch.exp(x - mnew[..., None])
                l = l + e.sum(-1)  # the normaliser counts dropped weights
                if rate > 0:
                    keep = torch.stack([keep_tile(q0, k0, True, b, h, seed,
                                                  rate, block_q)
                                        for h in range(H)])
                    e = torch.where(keep, e, 0.0)
                acc = acc + weights_times(e, vt, lo_half)
                m = mnew
            if Lk_pad > Lk:  # keys past Lk score -1e9 too (v = 0)
                l = l + (Lk_pad - Lk) * torch.exp(NEG_INF - m)
            div = 1.0 - rate if rate > 0 else 1.0
            n = min(TILE, Lq - q0)
            o[b, :, q0:q0 + n] = (acc / l[..., None] / div)[:, :n]
            m_out[b, :, q0:q0 + n] = m[:, :n]
            l_out[b, :, q0:q0 + n] = l[:, :n]
    return o, m_out, l_out


def emulate_dq(q, k, v, do, m, l, lengths, causal, rate, seed=SEED,
               lo_half=True):
    """The dQ kernel: two passes over each query block's key tiles, the
    first for D_i = sum_j a_ij da_ij, the second for dq."""
    B, H, Lq, Dh = q.shape
    Lk, G = k.shape[2], H // k.shape[1]
    scale = 1.0 / math.sqrt(Dh)
    block_q = FT.plan(Lq, Lk)[0]
    D = torch.zeros(B, H, Lq)
    dq = torch.zeros(B, H, Lq, Dh)
    for b in range(B):
        length = int(lengths[b])
        kb = k[b].repeat_interleave(G, 0)
        vb = v[b].repeat_interleave(G, 0)
        for q0 in range(0, Lq, TILE):
            rows = torch.arange(q0, q0 + TILE)
            qt, dot = rows_of(q[b], q0, Lq), rows_of(do[b], q0, Lq)
            idx = rows.clamp(max=Lq - 1)
            mt, lt = m[b][:, idx], l[b][:, idx]
            kend = key_end(length, Lk, Lq, q0, causal)

            def a_da(k0):
                keys = torch.arange(k0, k0 + TILE)
                kt, vt = rows_of(kb, k0, Lk), rows_of(vb, k0, Lk)
                s = qt @ kt.transpose(1, 2)
                dp = dot @ vt.transpose(1, 2)
                valid = keys[None, :] < length
                if causal:
                    valid = valid & (keys[None, :] <= rows[:, None])
                x = torch.where(valid, s * scale, NEG_INF)
                a = torch.exp(x - mt[..., None]) * (1.0 / lt)[..., None]
                if rate > 0:
                    keep = torch.stack([keep_tile(q0, k0, True, b, h, seed,
                                                  rate, block_q)
                                        for h in range(H)])
                    dp = torch.where(keep, dp * (1.0 / (1.0 - rate)), 0.0)
                live = keys < kend
                return (torch.where(live, a, 0.0),
                        torch.where(live, dp, 0.0), kt)

            Dt = sum((a * da).sum(-1) for a, da, _ in map(
                a_da, range(0, kend, TILE)))
            acc = torch.zeros(H, TILE, Dh)
            for k0 in range(0, kend, TILE):
                a, da, kt = a_da(k0)
                acc = acc + weights_times(a * (da - Dt[..., None]), kt,
                                          lo_half)
            n = min(TILE, Lq - q0)
            dq[b, :, q0:q0 + n] = acc[:, :n] * scale
            D[b, :, q0:q0 + n] = Dt[:, :n]
    return dq, D


def emulate_dkdv(q, k, v, do, m, l, D, lengths, causal, rate, seed=SEED,
                 lo_half=True):
    """The dK/dV kernel: each block of 64 keys walks (query head of its
    group, query tile of 64) in order."""
    B, H, Lq, Dh = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(Dh)
    block_q = FT.plan(Lq, Lk)[0]
    dk, dv = torch.zeros(k.shape), torch.zeros(v.shape)
    for b in range(B):
        length = int(lengths[b])
        for kvh in range(Hkv):
            for key0 in range(0, Lk, TILE):
                if length > 0 and key0 >= min(Lk, length):
                    continue  # weight 0 from every row
                keys = torch.arange(key0, key0 + TILE)
                kt = rows_of(k[b, kvh], key0, Lk)
                vt = rows_of(v[b, kvh], key0, Lk)
                i_begin = min(Lq, key0) if length > 0 and causal else 0
                dka, dva = torch.zeros(TILE, Dh), torch.zeros(TILE, Dh)
                for h in range(kvh * G, (kvh + 1) * G):
                    for i0 in range(i_begin, Lq, TILE):
                        qis = torch.arange(i0, i0 + TILE)
                        qt, dot = rows_of(q[b, h], i0, Lq), rows_of(do[b, h],
                                                                    i0, Lq)
                        ok = qis < Lq
                        idx = qis.clamp(max=Lq - 1)
                        mt = torch.where(ok, m[b, h, idx], 0.0)
                        ilt = torch.where(ok, 1.0 / l[b, h, idx], 0.0)
                        Dt = torch.where(ok, D[b, h, idx], 0.0)
                        st = kt @ qt.T   # keys x query rows
                        dpt = vt @ dot.T
                        valid = keys[:, None] < length
                        if causal:
                            valid = valid & (keys[:, None] <= qis[None, :])
                        x = torch.where(valid, st * scale, NEG_INF)
                        a = torch.exp(x - mt[None]) * ilt[None]
                        w = a
                        if rate > 0:
                            keep = keep_tile(key0, i0, False, b, h, seed,
                                             rate, block_q)
                            inv = 1.0 / (1.0 - rate)
                            w = torch.where(keep, a * inv, 0.0)
                            dpt = torch.where(keep, dpt * inv, 0.0)
                        ds = a * (dpt - Dt[None])
                        dva = dva + weights_times(w, dot, lo_half)
                        dka = dka + weights_times(ds, qt, lo_half)
                n = min(TILE, Lk - key0)
                dk[b, kvh, key0:key0 + n] = dka[:n] * scale
                dv[b, kvh, key0:key0 + n] = dva[:n]
    return dk, dv


def emulate_train(q, k, v, do, lengths, causal, rate, lo_half=True):
    """(o, dq, dk, dv) of the bf16 training kernels, each rounded to bf16
    once, as stored."""
    Lk_pad = FT.plan(q.shape[2], k.shape[2])[2]
    o, m, l = emulate_forward(q, k, v, lengths, causal, Lk_pad, rate,
                              lo_half=lo_half)
    dq, D = emulate_dq(q, k, v, do, m, l, lengths, causal, rate,
                       lo_half=lo_half)
    dk, dv = emulate_dkdv(q, k, v, do, m, l, D, lengths, causal, rate,
                          lo_half=lo_half)
    return tuple(x.to(torch.bfloat16) for x in (o, dq, dk, dv))


# ----------------------------------------------------------------- checks
def inputs(B, H, Hkv, Lq, Lk, seed):
    """bf16 q, k, v, do from a seed, a batch whose rows 1 and 2 have no
    real key and one real key."""
    rng = np.random.default_rng(seed)

    def bf16(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(torch.bfloat16)

    q, k, v, do = (bf16(B, H, Lq, 64), bf16(B, Hkv, Lk, 64),
                   bf16(B, Hkv, Lk, 64), bf16(B, H, Lq, 64))
    lengths = torch.as_tensor([Lk, 0, 1] + list(rng.integers(
        2, Lk + 1, B - 3)), dtype=torch.int32)
    return q, k, v, do, lengths


def err_over_bound(got, ref):
    """Worst |got - ref| over its TRAIN_TOL_BF16 bound; <= 1 passes."""
    rel, row = TRAIN_TOL_BF16
    ref = ref.float()
    d = (got.float() - ref).abs()
    mag = ref.abs()
    bound = rel * mag + row * mag.amax(-1, keepdim=True) + 1e-5 * mag.max()
    return torch.where(d == 0, 0.0, d / bound).max().item()


def flash_f32_ref(q, k, v, lengths, causal):
    """flash_attention_reference in float32 on the same (bf16) inputs."""
    return flash_attention_reference(q.float(), k.float(), v.float(),
                                     lengths, causal=causal)


def train_errors(Lq, Lk, causal, G, rate, lo_half=True):
    H = 4
    q, k, v, do, lengths = inputs(4, H, H // G, Lq, Lk, seed=Lq + Lk + G)
    got = emulate_train(q.float(), k.float(), v.float(), do.float(),
                        lengths, causal, rate, lo_half=lo_half)
    f32 = (q.float(), k.float(), v.float(), lengths,
           torch.tensor([SEED], dtype=torch.int32))
    refs = (FT.fused_attention_train_reference(*f32, rate, causal),
            *FT.fused_attention_train_reference_bwd(*f32, do.float(), rate,
                                                    causal))
    return {name: err_over_bound(g, r)
            for name, g, r in zip(("o", "dq", "dk", "dv"), got, refs)}


SHAPES = {"127x199": (127, 199), "199x199": (199, 199)}


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_keep_bits_placed_by_the_fragment_map_are_jax_bits(causal):
    """The lanes' accumulator elements cover a block's 64 x 64 tile once
    each, and over a whole call the keep bits the tiles compute at their
    fragments' (row, column), in both orientations, are the TPU kernel's
    mask (`keep_mask`, bit-exact against the Pallas kernel in
    test_torch_train_kernel.py)."""
    flat = FRAG_ROWS * TILE + FRAG_COLS
    assert torch.equal(torch.sort(flat).values, torch.arange(TILE * TILE))
    B, H, Lq, Lk, rate = 2, 2, 199, 199, 0.2
    block_q = FT.plan(Lq, Lk)[0]
    ref = FT.keep_mask(B, H, Lq, Lk, rate, SEED)
    for b in range(B):
        for h in range(H):
            for r0 in range(0, Lq, TILE):
                for c0 in range(0, Lk, TILE):
                    nr, nc = min(TILE, Lq - r0), min(TILE, Lk - c0)
                    t = keep_tile(r0, c0, True, b, h, SEED, rate, block_q)
                    assert torch.equal(t[:nr, :nc],
                                       ref[b, h, r0:r0 + nr, c0:c0 + nc])
                    tt = keep_tile(c0, r0, False, b, h, SEED, rate, block_q)
                    assert torch.equal(tt[:nc, :nr].T,
                                       ref[b, h, r0:r0 + nr, c0:c0 + nc])


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("G", [4, 1], ids=["gqa", "mha"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_flash_attention_tiles_within_flash_tol(causal, G, shape):
    """Kernel 1's bf16 route against `flash_attention_reference`, with a
    row of no real key (averaged over Lk) and one of one key: within
    FLASH_TOL of the plain version in bf16, and element by element within
    the TRAIN_KERNEL_TOL bound of the plain version in float32."""
    Lq, Lk = SHAPES[shape]
    q, k, v, _, lengths = inputs(4, 4, 4 // G, Lq, Lk, seed=Lq + G)
    o, _, _ = emulate_forward(q.float(), k.float(), v.float(), lengths,
                              causal, Lk_pad=Lk)
    ref = flash_attention_reference(q, k, v, lengths, causal=causal)
    err = (o.to(torch.bfloat16).float() - ref.float()).abs().max().item()
    assert err <= FLASH_TOL_BF16
    assert err_over_bound(o.to(torch.bfloat16), flash_f32_ref(
        q, k, v, lengths, causal)) <= 1.0
    # the row with no real key averages V over Lk
    mean_v = v[1].float().mean(1).repeat_interleave(G, 0)
    assert torch.allclose(o[1], mean_v[:, None].expand_as(o[1]), atol=1e-5)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("rate", [0.0, 0.2], ids=["rate0", "rate0.2"])
@pytest.mark.parametrize("G", [4, 1], ids=["gqa", "mha"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_training_tiles_within_train_kernel_tol(causal, G, rate, shape):
    """Kernel 3's bf16 route (forward, dQ, dK/dV) against the plain
    version in float32, every output within its element-wise bound."""
    errs = train_errors(*SHAPES[shape], causal, G, rate)
    assert max(errs.values()) <= 1.0, errs


def test_without_the_low_half_the_bound_breaks():
    """Rounding P, w and ds to bf16 alone (the usual tensor-core step)
    breaks the bound on at least one output: the low half is what keeps
    the kernels inside it."""
    errs = train_errors(199, 199, False, 4, 0.2, lo_half=False)
    assert max(errs.values()) > 1.0, errs


def test_flash_without_the_low_half_the_bound_breaks():
    """Kernel 1 with P rounded to bf16 alone stays within FLASH_TOL (an
    absolute bound over the output) but breaks the element-wise bound:
    that check, not FLASH_TOL, is what shows the low half is needed."""
    q, k, v, _, lengths = inputs(4, 4, 1, 199, 199, seed=203)
    o, _, _ = emulate_forward(q.float(), k.float(), v.float(), lengths,
                              False, Lk_pad=199, lo_half=False)
    got = o.to(torch.bfloat16)
    ref = flash_attention_reference(q, k, v, lengths)
    assert (got.float() - ref.float()).abs().max().item() <= FLASH_TOL_BF16
    assert err_over_bound(got, flash_f32_ref(q, k, v, lengths,
                                                False)) > 1.0
