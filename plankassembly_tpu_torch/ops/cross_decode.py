"""One decode step of cross-attention: the CUDA kernel that replaces the
Pallas `plankassembly_tpu/ops/cross_decode.py::cross_attn_decode`, and its
plain PyTorch version.

Semantics (both versions), per (batch, head) row r: scores = (q_r . k_rj)
* (sm_scale * k_scale_r) + bias_rj over the row's Li keys, a max-subtracted
softmax, then (sum_j p_j v_rj) * v_scale_r. K/V are int8 (with one
symmetric scale per row, folded into the scores and the output) or the
compute dtype (scales 1); everything is computed in float32 and the output
is float32.

Layout: the TPU kernel keeps K head-major and Dh-major, (BH, Dh, Li), for
its lane tiling. Here K and V are both (BH, Li, Dh): each key's Dh values
are contiguous, so a span of keys is one contiguous copy and a key's lanes
read neighbouring 16-byte pieces. The decode loop builds this layout once
per decode. Keys whose bias is at most NEG_INF / 2 count as masked: the
kernel skips a span of them without reading its K/V when its row has a
real key, which is exact as long as a masked key's weight is exactly 0 in
f32 (bias 0 on real keys and NEG_INF = -1e9 on masked ones, as every
caller gives).

A CPU tensor goes to `cross_attn_decode_reference`; a CUDA tensor goes to
the kernel in `csrc/cross_decode.cu` or raises.
"""
from __future__ import annotations

import torch

from plankassembly_tpu_torch.ops import _build

# launches of the CUDA kernel (one per call on a CUDA tensor)
launches = 0


def quantize_rows(x, dims):
    """Symmetric int8 quantization with one scale per leading row: the
    absmax over `dims` (kept as size-1 axes in the scale) / 127, at least
    1e-8, taken in float32. Returns (int8 values, f32 scales)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=dims, keepdim=True) / 127.0,
                        min=1e-8)
    return torch.round(xf / scale).to(torch.int8), scale


def cross_attn_decode_reference(q, k, v, bias, k_scale=None, v_scale=None,
                                *, sm_scale: float):
    """Plain version; follows the Pallas `_kernel` line by line."""
    BH = q.shape[0]
    ones = torch.ones((BH, 1), dtype=torch.float32, device=q.device)
    ks = ones if k_scale is None else k_scale.reshape(BH, 1).float()
    vs = ones if v_scale is None else v_scale.reshape(BH, 1).float()
    scores = torch.einsum("rd,rjd->rj", q.float(), k.float())
    scores = scores * (sm_scale * ks)
    scores = scores + bias.float()
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("rj,rjd->rd", p, v.float())
    return out * vs


def _check_inputs(q, k, v, bias, k_scale, v_scale):
    if q.dim() != 2 or k.dim() != 3:
        raise ValueError("q must be (BH, Dh) and k, v (BH, Li, Dh)")
    BH, Dh = q.shape
    if k.shape != v.shape or k.shape[0] != BH or k.shape[2] != Dh:
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} does "
                         f"not match q {tuple(q.shape)}")
    if bias.shape != (BH, k.shape[1]):
        raise ValueError(f"bias must be {(BH, k.shape[1])}, got "
                         f"{tuple(bias.shape)}")
    for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
        if s is not None and s.numel() != BH:
            raise ValueError(f"{name} must hold one scale per row")


def cross_attn_decode(q, k, v, bias, k_scale=None, v_scale=None, *,
                      sm_scale: float):
    """q (BH, Dh) in f32/bf16; k, v (BH, Li, Dh) int8 or q's dtype; bias
    (BH, Li) f32; k_scale, v_scale (BH, 1) f32 or None (1.0). Returns
    (BH, Dh) f32."""
    global launches
    _check_inputs(q, k, v, bias, k_scale, v_scale)
    if q.device.type == "cpu":
        return cross_attn_decode_reference(q, k, v, bias, k_scale, v_scale,
                                           sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    BH, Dh = q.shape
    Li = k.shape[1]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported query dtype {q.dtype}")
    if k.dtype != v.dtype or k.dtype not in (torch.int8, q.dtype):
        raise ValueError(f"k/v must both be int8 or {q.dtype}, got "
                         f"{k.dtype}/{v.dtype}")
    pieces = Dh * k.element_size() // 16
    if (Dh * k.element_size()) % 16 or pieces & (pieces - 1) or \
            pieces > 32 or Dh > 128:
        raise ValueError(f"the CUDA kernel reads a key in 16-byte pieces, "
                         f"one lane each, a power of two of them, and takes "
                         f"Dh <= 128; got Dh={Dh} of {k.dtype}")
    ts = [t.contiguous() for t in (q, k, v, bias.float())]
    # scales of None stay null pointers: the kernel takes them as 1
    scales = [None if s is None else s.reshape(BH).float().contiguous()
              for s in (k_scale, v_scale)]
    if any(t.device != q.device for t in ts + [s for s in scales if
                                               s is not None]):
        raise ValueError("every input must lie on q's device")
    out = torch.empty((BH, Dh), dtype=torch.float32, device=q.device)
    if BH == 0:
        return out
    code = _build.library().plank_cross_attn_decode(
        *(t.data_ptr() for t in ts),
        *(None if s is None else s.data_ptr() for s in scales),
        out.data_ptr(), BH, Li, Dh,
        float(sm_scale), int(q.dtype == torch.bfloat16),
        int(k.dtype == torch.int8), _build.stream_handle(q.device))
    launches += 1
    _build.check(code, "plank_cross_attn_decode")
    return out
