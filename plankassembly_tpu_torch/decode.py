"""Batched greedy decoding of shape programs.

Ports the serving path of `plankassembly_tpu/decode.py`: `greedy_decode`
crops (or pads) the packed inputs to the caller's `kv_bucket`, runs the
encoder with fused attention, and hands the memory to
`ops.persistent_decode.persistent_greedy_decode` — the int8 cross-KV /
bf16 self-KV greedy loop that `serving.make_live_backend` asks for
(`kv_quant=True`). Its semantics are those of the JAX package's
``greedy_decode(kv_quant=True, self_quant=False, cross_impl="xla")``:

- per-layer cross-attention K/V over the memory, int8 with one symmetric
  scale per (layer, row, kv head) taken over every memory position;
- a self K/V cache in the compute dtype, and an f32 cache of the final
  hidden states for the pointer head;
- the reference's mixed vocab ‖ pointer ‖ switch sampler (`_mixed_sample`)
  with its quirks, and early exit once every row has emitted END.
"""
from __future__ import annotations

import numpy as np
import torch

from plankassembly_tpu_torch.config import ModelDims
from plankassembly_tpu_torch.models.model import NEG_INF, encode

EPS = 1e-6


def precompute_cross_kv(params, memory, dims: ModelDims, compute_dtype):
    """Per-layer cross-attention K/V over the encoder memory:
    (L, B, Li, kvH, Dh) each, in `compute_dtype`."""
    B, Li, _ = memory.shape
    ca = params["decoder"]["cross_attn"]
    cd = compute_dtype
    m = memory.to(cd)
    k = (torch.einsum("bld,nde->nble", m, ca["wk"].to(cd))
         + ca["bk"].to(cd)[:, None, None, :])
    v = (torch.einsum("bld,nde->nble", m, ca["wv"].to(cd))
         + ca["bv"].to(cd)[:, None, None, :])
    shape = (dims.num_decoder_layers, B, Li, dims.kv_heads, dims.head_dim)
    return k.reshape(shape), v.reshape(shape)


def quantize_cross_kv(x):
    """Symmetric int8 over (Li, Dh) for each (layer, row, kv head):
    x (L, B, Li, kvH, Dh) -> (int8 values, f32 scales (L, B, 1, kvH, 1))."""
    xf = x.float()
    scale = xf.abs().amax(dim=(2, 4), keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-8)
    return torch.round(xf / scale).to(torch.int8), scale


def _mixed_sample(heads, dims: ModelDims, struct, pos, h_t, h_cache,
                  output, attach, done, t):
    """Sampling tail of one step: mixed vocab ‖ pointer ‖ switch
    distribution and the greedy pointer-resolving argmax, with the
    reference quirks (eps-fill of illegal pointer slots, plain-vocab argmax
    for the first plank's 6 coords, first index on ties). Updates
    output/attach/done in place at column t."""
    S = dims.max_output_length
    vocab_logits = h_t @ heads["vocab"]["w"] + heads["vocab"]["b"]
    vocab_probs = torch.softmax(vocab_logits, dim=-1)
    feature = h_t @ heads["pointer"]["w"] + heads["pointer"]["b"]
    pointer_logits = torch.einsum("bd,bsd->bs", feature, h_cache)
    pointer_logits = pointer_logits / dims.num_model
    prob = torch.sigmoid(h_t @ heads["switch"]["w"] + heads["switch"]["b"])

    triu_bias = torch.where(pos >= t, NEG_INF, 0.0)[None, :]
    pointer_probs = torch.softmax(pointer_logits + triu_bias, dim=-1) * prob
    pointer_probs = torch.where(struct[t][None, :] == 0,
                                torch.tensor(EPS, device=h_t.device),
                                pointer_probs)
    # restrict candidates to j <= t (the reference dist is only t+1 wide)
    pointer_probs = torch.where(pos[None, :] > t,
                                torch.tensor(-1.0, device=h_t.device),
                                pointer_probs)

    mixed = torch.cat([vocab_probs * (1 - prob), pointer_probs], dim=-1)
    # torch.argmax returns the first maximal index, as jnp.argmax does
    mixed_idx = torch.argmax(mixed, dim=-1)
    vocab_idx = torch.argmax(vocab_logits, dim=-1)
    idx = vocab_idx if t + 1 < dims.num_output_dof else mixed_idx

    is_ptr = idx >= dims.vocab_size
    ptr = torch.clamp(idx - dims.vocab_size, 0, S - 1)
    copied = torch.gather(output, 1, ptr[:, None])[:, 0]
    token = torch.where(is_ptr, copied, idx.to(output.dtype))
    output[:, t] = token
    attach[:, t] = torch.where(is_ptr, ptr, -1).to(attach.dtype)
    done |= token == dims.end


def _pad_or_crop(inputs: dict, kv_bucket, dims: ModelDims) -> dict:
    """Crop to `kv_bucket` (real tokens are a prefix, so this is exact) or
    pad with masked PAD columns up to it (masked positions are inert)."""
    width = inputs["input_value"].shape[1]
    if kv_bucket is None or kv_bucket == width:
        return inputs
    if kv_bucket < width:
        return {k: v[:, :kv_bucket] for k, v in inputs.items()}
    pad = kv_bucket - width
    out = {}
    for k, v in inputs.items():
        if k == "input_mask":
            fill = torch.ones((v.shape[0], pad), dtype=v.dtype, device=v.device)
        elif k == "input_value":
            fill = torch.full((v.shape[0], pad), dims.vocab_size - 1,
                              dtype=v.dtype, device=v.device)
        else:
            fill = torch.zeros((v.shape[0], pad), dtype=v.dtype, device=v.device)
        out[k] = torch.cat([v, fill], dim=1)
    return out


@torch.no_grad()
def greedy_decode(params, batch: dict, dims: ModelDims,
                  compute_dtype=torch.bfloat16, early_exit=True,
                  kv_bucket=None):
    """Batched greedy decode on the device of `batch`'s tensors. Returns
    samples (B, S) int32, attach (B, S) int32 (-1 = no pointer) and
    num_steps (int, steps executed)."""
    from plankassembly_tpu_torch.ops.persistent_decode import (
        persistent_greedy_decode,
    )

    inputs = {k: v for k, v in batch.items() if k.startswith("input")}
    inputs = _pad_or_crop(inputs, kv_bucket, dims)
    memory = encode(params, inputs, dims, compute_dtype=compute_dtype,
                    flash=True)
    # The JAX package pads memory to a multiple of 128 here because its
    # Pallas kernel needs lane-aligned slices (decode.py:298-310); the CUDA
    # kernels take any width, so no pad is needed.
    return persistent_greedy_decode(params, memory, inputs["input_mask"],
                                    dims, compute_dtype=compute_dtype,
                                    early_exit=early_exit)


def pick_kv_bucket(input_mask, quantum: int = 128) -> int:
    """Smallest multiple of `quantum` covering every real input token in
    the batch, capped at the packed width."""
    mask = np.asarray(input_mask.cpu() if torch.is_tensor(input_mask)
                      else input_mask, dtype=bool)
    width = int(mask.shape[-1])
    lengths = (~mask).sum(axis=-1)
    max_len = int(lengths.max()) if lengths.size else quantum
    bucket = int(-(-max_len // quantum) * quantum)
    return min(bucket, width)


def parse_sequence(sequence, dims: ModelDims) -> np.ndarray:
    """Truncate at the first END and reshape to (P, 6)."""
    sequence = np.asarray(sequence)
    ends = np.flatnonzero(sequence == dims.end)
    valid = sequence[: ends[0]] if len(ends) else sequence
    num_plank = len(valid) // dims.num_output_dof
    return valid[: num_plank * dims.num_output_dof].reshape(
        -1, dims.num_output_dof)
