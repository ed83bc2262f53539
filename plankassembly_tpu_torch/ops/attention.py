"""Fused attention: the CUDA kernel that replaces the Pallas
`plankassembly_tpu/ops/attention.py::flash_attention`, and its plain
PyTorch version.

Semantics (both versions): exact softmax attention of q (B,H,Lq,Dh) over
k/v (B,Hkv,Lk,Dh), query head h reading kv head h // (H/Hkv) — so a
grouped-query model passes its kv-head-wide K/V without repeating them.
Keys j >= kv_lengths[b] (and j > i when `causal`) score NEG_INF = -1e9,
not -inf, so a row whose keys are all masked averages V uniformly instead
of giving NaN. Accumulation is float32; the output has q's dtype.

A CPU tensor goes to `flash_attention_reference`; a CUDA tensor goes to
the kernel in `csrc/attention.cu` or raises: bf16 to the tensor-core
kernel (`csrc/attn_mma.cuh`), float32 to the SIMT one.
"""
from __future__ import annotations

import math

import torch

from plankassembly_tpu_torch.ops import _build

NEG_INF = -1e9

# launches of the CUDA kernel (one per call on a CUDA tensor)
launches = 0


def flash_attention_reference(q, k, v, kv_lengths, *, causal=False,
                              sm_scale=None):
    """Plain PyTorch version: materialises the (B,H,Lq,Lk) scores."""
    B, H, Lq, Dh = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    sm_scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(Dh)
    G = H // Hkv
    if G > 1:
        k = k.repeat_interleave(G, dim=1)
        v = v.repeat_interleave(G, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    col = torch.arange(Lk, device=q.device)
    mask = col[None, None, None, :] < kv_lengths.to(q.device)[:, None, None, None]
    if causal:
        row = torch.arange(Lq, device=q.device)
        mask = mask & (col[None, None, None, :] <= row[None, None, :, None])
    scores = torch.where(mask, scores, torch.tensor(NEG_INF, device=q.device))
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, v.float()).to(q.dtype)


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


def flash_attention(q, k, v, kv_lengths, *, causal=False, sm_scale=None):
    """q (B,H,Lq,Dh), k/v (B,Hkv,Lk,Dh), kv_lengths (B,) int. Returns
    (B,H,Lq,Dh) in q.dtype."""
    global launches
    _check_inputs(q, k, v, kv_lengths)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, kv_lengths, causal=causal,
                                         sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, H, Lq, Dh = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    if Dh != 64:
        raise ValueError(f"the CUDA flash_attention kernel takes Dh=64 only, "
                         f"got {Dh}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported dtype {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q's dtype and device")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lengths = kv_lengths.to(device=q.device, dtype=torch.int32).contiguous()
    sm_scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(Dh)
    out = torch.empty_like(q)
    lib = _build.library()
    code = lib.plank_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), B, H, Hkv, Lq, Lk, Dh, sm_scale, int(causal),
        int(q.dtype == torch.bfloat16), _build.stream_handle(q.device))
    launches += 1
    _build.check(code, "plank_flash_attention")
    return out
