"""Differentiable attention with in-kernel hashed dropout (training path):
the CUDA kernels that replace the Pallas
`plankassembly_tpu/ops/flash_train.py::fused_attention_train` (forward
`_fwd_kernel` and backward `_bwd_kernel` under a custom VJP), and their
plain PyTorch version.

Semantics (both versions), for q (B,H,Lq,Dh), k/v (B,Hkv,Lk,Dh) with
query head h reading kv head h // (H/Hkv):

- scores (q . k) * sm_scale in float32; keys j >= kv_lengths[b] (and
  j > i when `causal`) score NEG_INF = -1e9, and the softmax runs over Lk
  padded to a multiple of 128, as the TPU kernel's does — so a row with no
  real key averages V over that padded width (the pad keys have v = 0);
- dropout multiplies the normalised weights: w = keep ? a / (1-rate) : 0,
  with `keep` the TPU kernel's counter hash of (local row, global column,
  cell seed) under the TPU plan's query blocking (`plan`,
  `dropout_keep_mask`), so the mask bits are JAX's bit for bit;
- the gradients are the TPU kernel's: the softmax is recomputed and ds is
  not masked (a row with no real key passes gradient to its masked
  scores, as there);
- o and dq in q's dtype; dk and dv in k's dtype, summed over each kv
  head's query-head group in float32 (the gradient of JAX's repeat).

A CPU tensor goes to the plain version (`fused_attention_train_reference`
forward, `fused_attention_train_reference_bwd` backward); a CUDA tensor
goes to the kernels in `csrc/flash_train.cu` or raises: bf16 to the
tensor-core kernels (`csrc/attn_mma.cuh`), float32 to the SIMT ones.
"""
from __future__ import annotations

import math

import torch

from plankassembly_tpu_torch.ops import _build

NEG_INF = -1e9
BLOCK_Q = 512  # the TPU kernel's default query block (`block_q=512`)

# launches of the CUDA kernels, counted where they launch: the forward,
# and the backward's pair (dQ, then dK/dV) counted once per call
fwd_launches = 0
bwd_launches = 0

_M32 = 0xFFFFFFFF


def plan(Lq: int, Lk: int, block_q: int = BLOCK_Q) -> tuple[int, int, int]:
    """The TPU kernel's blocking (`_plan`, flash_train.py:181-187):
    (query block, Lq padded to it, Lk padded to a multiple of 128)."""
    block_q = min(block_q, max(128, 1 << (Lq - 1).bit_length()))
    return block_q, Lq + (-Lq % block_q), Lk + (-Lk % 128)


def dropout_threshold(rate: float) -> int:
    """keep when the hash >= this (`_dropout_mask`'s threshold)."""
    return min(int(rate * (2.0 ** 32)), 2 ** 32 - 1)


def _mul32(x, c: int):
    """(x * c) mod 2^32 for int64 x in [0, 2^32): split c so that no
    product leaves int64."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def cell_seed(seed, b, h, qi):
    """`_cell_seed` (flash_train.py:47-49) in wrapping 32-bit arithmetic,
    as an unsigned value in int64; h is the query head."""
    return (seed + b * 7919 + h * 104729 + qi * 1299721) & _M32


def shard_seed(seed, row0: int, head0: int):
    """The seed under which a call on rows row0.. and query heads head0..
    of a larger call draws that call's masks: the cell seed is linear in b
    and h, so the offsets fold into the seed (wrapping int32, on the seed's
    device). `seed` as `fused_attention_train` takes it."""
    off = row0 * 7919 + head0 * 104729
    if not off:
        return seed
    s = (torch.as_tensor(seed).to(torch.int64) + off) & _M32
    return torch.where(s >= 2 ** 31, s - 2 ** 32, s).to(torch.int32)


def _hash(rc, cell):
    """The finaliser of `_dropout_mask` given rc = (r*A) ^ (c*B) mod 2^32
    and the cell seed, all int64 holding uint32 values."""
    x = (rc + _mul32(cell & _M32, 0xC2B2AE35)) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _row_col(r, c):
    return _mul32(r, 0x9E3779B9) ^ _mul32(c, 0x85EBCA6B)


def dropout_keep_mask(rows: int, cols: int, rate: float, cell_seed,
                      device=None) -> torch.Tensor:
    """`_dropout_mask((rows, cols), rate, cell_seed)`: the keep mask of one
    TPU grid cell, local rows 0..rows-1 and columns 0..cols-1. `cell_seed`
    is an int or an integer tensor (its shape broadcasts in front)."""
    cell = torch.as_tensor(cell_seed, dtype=torch.int64, device=device)
    r = torch.arange(rows, dtype=torch.int64, device=cell.device)[:, None]
    c = torch.arange(cols, dtype=torch.int64, device=cell.device)[None, :]
    ux = _hash(_row_col(r, c), cell[..., None, None])
    return ux >= dropout_threshold(rate)


def keep_mask(B: int, H: int, Lq: int, cols: int, rate: float, seed,
              device=None) -> torch.Tensor:
    """(B, H, Lq, cols) keep mask of a whole call, global query row i in
    the TPU plan's cell i // block_q at local row i % block_q. Built one
    batch row at a time to bound its int64 temporaries."""
    block_q = plan(Lq, cols)[0]
    seed = torch.as_tensor(seed, device=device).to(torch.int64).reshape(())
    dev = seed.device
    i = torch.arange(Lq, dtype=torch.int64, device=dev)
    c = torch.arange(cols, dtype=torch.int64, device=dev)
    rc = _row_col((i % block_q)[:, None], c[None, :])
    qi = (i // block_q)[None, :]
    h = torch.arange(H, dtype=torch.int64, device=dev)[:, None]
    thr = dropout_threshold(rate)
    out = torch.empty((B, H, Lq, cols), dtype=torch.bool, device=dev)
    for b in range(B):
        cell = cell_seed(seed, b, h, qi)                   # (H, Lq)
        out[b] = _hash(rc[None], cell[:, :, None]) >= thr
    return out


def _check_inputs(q, k, v, kv_lengths):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, H, L, Dh)")
    B, H, Lq, Dh = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != Dh:
        raise ValueError(f"k/v shape {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if H % k.shape[1]:
        raise ValueError(f"H={H} is not a multiple of kv heads {k.shape[1]}")
    if kv_lengths.shape != (B,):
        raise ValueError(f"kv_lengths must be ({B},), got "
                         f"{tuple(kv_lengths.shape)}")


def _weights(q, k, kv_lengths, seed, rate, causal, sm_scale):
    """(a, w, keep, k and padded to Lkp, repeated over groups)."""
    B, H, Lq, Dh = q.shape
    Lk = k.shape[2]
    Lkp = plan(Lq, Lk)[2]
    kf = k.float().repeat_interleave(H // k.shape[1], dim=1)
    kf = torch.nn.functional.pad(kf, (0, 0, 0, Lkp - Lk))
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * sm_scale
    col = torch.arange(Lkp, device=q.device)
    mask = col[None, None, None, :] < \
        kv_lengths.to(q.device)[:, None, None, None]
    if causal:
        row = torch.arange(Lq, device=q.device)
        mask = mask & (col[None, None, None, :] <= row[None, None, :, None])
    s = torch.where(mask, s, torch.tensor(NEG_INF, device=q.device))
    del mask
    a = torch.softmax(s, dim=-1)
    del s
    if rate > 0.0:
        keep = keep_mask(B, H, Lq, Lkp, rate, seed, device=q.device)
        w = torch.where(keep, a / (1.0 - rate), 0.0)
    else:
        keep, w = None, a
    return a, w, keep, kf


def _sm_scale(sm_scale, Dh):
    return sm_scale if sm_scale is not None else 1.0 / math.sqrt(Dh)


def fused_attention_train_reference(q, k, v, kv_lengths, seed, rate=0.0,
                                    causal=False, sm_scale=None):
    """Plain forward: materialises the (B,H,Lq,Lk) scores. Returns o in
    q's dtype."""
    _check_inputs(q, k, v, kv_lengths)
    B, H, Lq, Dh = q.shape
    sm_scale = _sm_scale(sm_scale, Dh)
    _, w, _, kf = _weights(q, k, kv_lengths, seed, rate, causal, sm_scale)
    vf = torch.nn.functional.pad(
        v.float().repeat_interleave(H // k.shape[1], dim=1),
        (0, 0, 0, kf.shape[2] - k.shape[2]))
    return torch.einsum("bhqk,bhkd->bhqd", w, vf).to(q.dtype)


def fused_attention_train_reference_bwd(q, k, v, kv_lengths, seed, do,
                                        rate=0.0, causal=False,
                                        sm_scale=None):
    """Plain backward, as the TPU kernel's `_bwd_kernel`: recompute the
    softmax and the mask, then (dq, dk, dv)."""
    _check_inputs(q, k, v, kv_lengths)
    B, H, Lq, Dh = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    sm_scale = _sm_scale(sm_scale, Dh)
    a, w, keep, kf = _weights(q, k, kv_lengths, seed, rate, causal,
                              sm_scale)
    Lkp = kf.shape[2]
    vf = torch.nn.functional.pad(
        v.float().repeat_interleave(H // Hkv, dim=1), (0, 0, 0, Lkp - Lk))
    dof = do.float()
    dv = torch.einsum("bhqk,bhqd->bhkd", w, dof)
    del w
    da = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    if keep is not None:
        da = torch.where(keep, da / (1.0 - rate), 0.0)
        del keep
    ds = a * (da - (da * a).sum(dim=-1, keepdim=True))
    del a, da
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * sm_scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * sm_scale

    def group_sum(x):
        return x[:, :, :Lk].reshape(B, Hkv, H // Hkv, Lk, Dh).sum(dim=2)

    return (dq.to(q.dtype), group_sum(dk).to(k.dtype),
            group_sum(dv).to(v.dtype))


def _seed_tensor(seed, device):
    return torch.as_tensor(seed, device=device).to(torch.int32).reshape(1)


def _check_cuda(q, k, v):
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.shape[3] != 64:
        raise ValueError(f"the CUDA fused_attention_train kernels take Dh=64 "
                         f"only, got {q.shape[3]}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported dtype {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q's dtype and device")


def _dropout_args(rate, Lq, Lk):
    block_q = plan(Lq, Lk)[0]
    return (int(rate > 0.0), dropout_threshold(rate) if rate > 0.0 else 0,
            1.0 - rate, block_q)


def kernel_forward(q, k, v, kv_lengths, seed, rate, causal, sm_scale):
    """Launch the forward kernel: (o, per-row (max, sum))."""
    global fwd_launches
    _check_cuda(q, k, v)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    B, H, Lq, Dh = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    lengths = kv_lengths.to(device=q.device, dtype=torch.int32).contiguous()
    seed_t = _seed_tensor(seed, q.device)
    out = torch.empty_like(q)
    stats = torch.empty((B, H, Lq, 2), dtype=torch.float32, device=q.device)
    lib = _build.library()
    code = lib.plank_flash_train_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        seed_t.data_ptr(), out.data_ptr(), stats.data_ptr(),
        B, H, Hkv, Lq, Lk, Dh, plan(Lq, Lk)[2], _sm_scale(sm_scale, Dh),
        int(causal), *_dropout_args(rate, Lq, Lk),
        int(q.dtype == torch.bfloat16), _build.stream_handle(q.device))
    _build.check(code, "plank_flash_train_fwd")
    fwd_launches += 1
    return out, stats


def kernel_backward(q, k, v, kv_lengths, seed, do, stats, rate, causal,
                    sm_scale):
    """Launch the backward kernels (dQ, then dK/dV): (dq, dk, dv)."""
    global bwd_launches
    _check_cuda(q, k, v)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    do = do.to(q.dtype).contiguous()
    B, H, Lq, Dh = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    lengths = kv_lengths.to(device=q.device, dtype=torch.int32).contiguous()
    seed_t = _seed_tensor(seed, q.device)
    dbuf = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = _build.library()
    code = lib.plank_flash_train_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lengths.data_ptr(), seed_t.data_ptr(), stats.data_ptr(),
        dbuf.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H,
        Hkv, Lq, Lk, Dh, _sm_scale(sm_scale, Dh),
        int(causal), *_dropout_args(rate, Lq, Lk),
        int(q.dtype == torch.bfloat16), _build.stream_handle(q.device))
    _build.check(code, "plank_flash_train_bwd")
    bwd_launches += 1
    return dq, dk, dv


class _Kernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_lengths, seed, rate, causal, sm_scale):
        out, stats = kernel_forward(q, k, v, kv_lengths, seed, rate, causal,
                                    sm_scale)
        ctx.save_for_backward(q, k, v, kv_lengths, torch.as_tensor(seed),
                              stats)
        ctx.args = (rate, causal, sm_scale)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, kv_lengths, seed, stats = ctx.saved_tensors
        dq, dk, dv = kernel_backward(q, k, v, kv_lengths, seed, do, stats,
                                     *ctx.args)
        return dq, dk, dv, None, None, None, None, None


class _Plain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_lengths, seed, rate, causal, sm_scale):
        ctx.save_for_backward(q, k, v, kv_lengths, torch.as_tensor(seed))
        ctx.args = (rate, causal, sm_scale)
        return fused_attention_train_reference(q, k, v, kv_lengths, seed,
                                               rate, causal, sm_scale)

    @staticmethod
    def backward(ctx, do):
        q, k, v, kv_lengths, seed = ctx.saved_tensors
        dq, dk, dv = fused_attention_train_reference_bwd(
            q, k, v, kv_lengths, seed, do, *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def fused_attention_train(q, k, v, kv_lengths, seed, rate=0.0, causal=False,
                          sm_scale=None):
    """q (B,H,Lq,Dh), k/v (B,Hkv,Lk,Dh), kv_lengths (B,) int, seed an int
    or a one-element integer tensor (on q's device, so that drawing it
    needs no host sync). Differentiable in q, k and v; returns (B,H,Lq,Dh)
    in q.dtype."""
    _check_inputs(q, k, v, kv_lengths)
    if q.device.type == "cpu":
        return _Plain.apply(q, k, v, kv_lengths, seed, rate, causal,
                            sm_scale)
    return _Kernel.apply(q, k, v, kv_lengths, seed, rate, causal, sm_scale)
