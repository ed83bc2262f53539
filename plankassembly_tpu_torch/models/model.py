"""The encoder-decoder's building blocks, eager PyTorch.

Ports `plankassembly_tpu/models/model.py` with the same parameter layout
(nested dict, layers stacked on the leading axis, ``x @ W`` projections)
and the same dtype policy: matmuls in `compute_dtype`, scores, softmax and
layer norms in float32, the residual stream in the parameters' dtype.

The encoder's projections and FFN are large plain products that the JAX
package leaves to XLA; here they are `torch.matmul`. Its attention goes
through `ops.attention.flash_attention`, which indexes the kv head of a
grouped-query model directly instead of repeating K/V.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from plankassembly_tpu_torch.config import ModelDims
from plankassembly_tpu_torch.ops.attention import flash_attention

NEG_INF = -1e9  # finite -inf stand-in: keeps softmax NaN-free on masked rows


def layer_norm(p, x, eps=1e-5):
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = ((x32 - mean) ** 2).mean(-1, keepdim=True)
    out = (x32 - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return out.to(x.dtype)


def _project(x, w, b, cd):
    return x.to(cd) @ w.to(cd) + b.to(cd)


def attention(p, q_in, kv_in, bias, dims: ModelDims, *,
              compute_dtype=torch.bfloat16, kv_lengths=None, flash=False,
              causal=False):
    """Multi-head (or grouped-query) attention. q_in (B,Lq,D), kv_in
    (B,Lk,D); bias broadcastable to (B,H,Lq,Lk) with 0 / NEG_INF entries.

    With `flash` and `kv_lengths` (B,) (pad keys form a suffix), the scores
    never materialise: `flash_attention` takes the kv-head-wide K/V and the
    lengths. Otherwise the plain einsum path with the additive bias runs,
    repeating K/V over each group as the JAX model does."""
    B, Lq, _ = q_in.shape
    H, Dh, kvH, G = dims.num_head, dims.head_dim, dims.kv_heads, dims.kv_groups
    cd = compute_dtype
    q = _project(q_in, p["wq"], p["bq"], cd).reshape(B, Lq, H, Dh)
    k = _project(kv_in, p["wk"], p["bk"], cd).reshape(B, -1, kvH, Dh)
    v = _project(kv_in, p["wv"], p["bv"], cd).reshape(B, -1, kvH, Dh)
    if flash and kv_lengths is not None:
        out = flash_attention(q.transpose(1, 2).contiguous(),
                              k.transpose(1, 2).contiguous(),
                              v.transpose(1, 2).contiguous(), kv_lengths,
                              causal=causal).transpose(1, 2)
    else:
        if G > 1:
            k = k.repeat_interleave(G, dim=2)
            v = v.repeat_interleave(G, dim=2)
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        scores = scores / math.sqrt(Dh)
        if bias is not None:
            scores = scores + bias
        weights = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", weights.to(cd).float(),
                           v.float()).to(cd)
    out = out.reshape(B, Lq, H * Dh).to(cd)
    out = out @ p["wo"].to(cd) + p["bo"].to(cd)
    return out.to(q_in.dtype)


def ffn(p, x, dims: ModelDims, *, compute_dtype=torch.bfloat16):
    cd = compute_dtype
    h = torch.relu(_project(x, p["w1"], p["b1"], cd))
    out = h @ p["w2"].to(cd) + p["b2"].to(cd)
    return out.to(x.dtype)


def _take_layer(stacked, i):
    return {k: (_take_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in stacked.items()}


def encode(params, inputs: dict, dims: ModelDims, *,
           compute_dtype=torch.bfloat16, flash=False):
    """Embed the input streams and run the pre-norm encoder stack.

    inputs: input_value/pos/coord/view[/type] (B, Li) integer tensors and
    input_mask (B, Li) bool (True = pad). Returns memory (B, Li, D) in the
    parameters' dtype."""
    emb = params["embed"]
    x = (emb["value"][inputs["input_value"].long()]
         + emb["pos_in"][inputs["input_pos"].long()]
         + emb["coord_in"][inputs["input_coord"].long()]
         + emb["view"][inputs["input_view"].long()])
    if "input_type" in inputs:
        x = x + emb["type"][inputs["input_type"].long()]
    return run_encoder_stack(params, x, inputs["input_mask"], dims,
                             compute_dtype=compute_dtype, flash=flash)


def run_encoder_stack(params, x, input_mask, dims: ModelDims, *,
                      compute_dtype=torch.bfloat16, flash=False):
    """Pre-norm encoder over embedded tokens x (B, L, D), eval mode."""
    pad_bias = torch.where(input_mask, NEG_INF, 0.0)[:, None, None, :].to(
        device=x.device, dtype=torch.float32)
    # pads are a suffix (data/packing.py), so a per-row length is an exact
    # stand-in for the pad mask on the flash path
    kv_lengths = (~input_mask).sum(dim=-1).to(torch.int32)
    enc = params["encoder"]
    for i in range(dims.num_encoder_layers):
        lp = _take_layer({k: v for k, v in enc.items() if k != "final_norm"}, i)
        h = layer_norm(lp["norm1"], x)
        x = x + attention(lp["self_attn"], h, h, pad_bias, dims,
                          compute_dtype=compute_dtype, kv_lengths=kv_lengths,
                          flash=flash)
        h = layer_norm(lp["norm2"], x)
        x = x + ffn(lp["ffn"], h, dims, compute_dtype=compute_dtype)
    return layer_norm(enc["final_norm"], x)


def embed_output(params, output_value, dims: ModelDims):
    """Shifted decoder input embeddings with the zero BOS vector: position
    j >= 1 embeds token j-1 with coord (j-1)%6 and pos (j-1)//6.
    output_value (B, T) -> (B, T+1, D)."""
    emb = params["embed"]
    B, T = output_value.shape
    positions = torch.arange(T, device=output_value.device)
    x = (emb["value"][output_value.long()]
         + emb["coord_out"][positions % dims.num_output_dof][None]
         + emb["pos_out"][positions // dims.num_output_dof][None])
    zero = torch.zeros((B, 1, x.shape[-1]), dtype=x.dtype, device=x.device)
    return torch.cat([zero, x], dim=1)


def pointer_structure_mask(dims: ModelDims) -> np.ndarray:
    """(S, S) 0/1 mask of legal attachments: coordinate k of a plank may
    point to coordinate (k+3)%6 of an earlier plank, or to the same
    coordinate of the bbox (row 0); bbox tokens never point."""
    S = dims.max_output_length
    dof = dims.num_output_dof
    i = np.arange(S)[:, None]
    j = np.arange(S)[None, :]
    plank2plank = (j % dof) == ((i % dof) + dof // 2) % dof
    plank2bbox = (j % dof) == (i % dof)
    mask = np.where(j < dof, plank2bbox, plank2plank).astype(np.float32)
    mask[:dof, :] = 0.0
    return mask
