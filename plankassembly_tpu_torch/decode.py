"""Batched greedy decoding of shape programs.

Ports the KV-cached decode of `plankassembly_tpu/decode.py`:
`greedy_decode` crops (or pads) the packed inputs to the caller's
`kv_bucket`, runs the encoder with fused attention, and hands the memory to
`decode_from_memory`, which runs one of the JAX package's decode paths
(`cross_impl`):

- "auto" (the default, as in JAX): resolved per call by `_pick_auto_impl`
  from the device, the batch and the options. Off CUDA it is "xla"; on
  CUDA it is "persistent" when the caller opted into its built-in
  semantics (`kv_quant`, grouped-query K/V, no `self_quant`, no weight
  quantization) and the batch lies in the band measured on the card
  (`PERSISTENT_BATCHES`), else "mxu". With `kv_quant` unset that is the
  full-precision path;
- "persistent": `ops.persistent_decode`, the int8 cross-KV /
  compute-dtype self-KV loop of CUDA kernels; its semantics are JAX's
  ``cross_impl="xla", kv_quant=True, self_quant=False``;
- "xla": the plain einsum loop, cross K/V in the compute dtype or int8
  (`kv_quant`) with the scale taken in the compute dtype;
- "mxu": the block-diagonal-query form of the same loop, int8 K/V scales
  folded into the query and the output, and (with `self_quant`, which
  follows `kv_quant` unless given) an int8 self K/V cache with one scale
  per appended token; the hidden cache is kept in the compute dtype;
- "kernel": the "xla" loop with each step's cross-attention in the CUDA
  kernel `ops.cross_decode.cross_attn_decode` (MHA only: a grouped-query
  model takes "mxu" on the GPU and "xla" on the CPU, as the JAX package
  takes "mxu" on its TPU);
- "fused": every decoder layer of a step in the CUDA kernels
  `ops.fused_decode.fused_decoder_layer` / `fused_ffn` over int8 self and
  cross caches (MHA only), with a compute-dtype hidden cache.

"xla" and "mxu" also take int8 decoder and head weights (`weight_quant`,
or weights already quantized by `quantize_decoder_weights`), and
`gqa_self_impl` picks how grouped-query attention contracts. Every path
ends each step with the reference's mixed vocab ‖ pointer ‖ switch sampler
(`_mixed_sample`) and its quirks, and exits once every row has emitted END
(rows that ended earlier keep decoding trailing tokens).
`greedy_decode_nocache` recomputes the whole decoder stack over the prefix
at every step: the parity oracle of the cached paths and the baseline a
benchmark compares them with.
"""
from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from plankassembly_tpu_torch.config import ModelDims
from plankassembly_tpu_torch.models.model import (
    NEG_INF, decode_stack, embed_output, encode, layer_norm,
    pointer_structure_mask,
)
from plankassembly_tpu_torch.ops import cross_decode as CD
from plankassembly_tpu_torch.ops import fused_decode as FD

EPS = 1e-6
IMPLS = ("auto", "persistent", "xla", "mxu", "kernel", "fused")
GQA_SELF_IMPLS = ("auto", "expand", "grouped")
# steps between two host reads of the all-done flags in the plain loops
CHECK_EVERY = 8
# the batches (smallest, largest) at which "auto" takes "persistent" on
# CUDA: where `chip_smoke.py` decode_options timed the persistent loop
# faster than "mxu" (ep221, bf16, bucket 1152; PERF.md §5)
PERSISTENT_BATCHES = (1, 512)


def _pick_auto_impl(device_type: str, dims: ModelDims, batch: int, *,
                    kv_quant: bool, self_quant: bool, weight_quant: bool,
                    prequantized: bool) -> str:
    """Resolve cross_impl="auto" (JAX `decode._pick_auto_impl` with the
    CUDA device in the TPU's place). Off CUDA: "xla". On CUDA: the
    persistent kernels when the caller accepted their built-in semantics
    (int8 cross K/V, grouped-query layout, no int8 self K/V or weights)
    and the batch lies in `PERSISTENT_BATCHES`; otherwise "mxu"."""
    if device_type != "cuda":
        return "xla"
    lo, hi = PERSISTENT_BATCHES
    if (kv_quant and dims.kv_heads < dims.num_head
            and not self_quant and not weight_quant and not prequantized
            and lo <= batch <= hi):
        return "persistent"
    return "mxu"


def _is_prequantized(w) -> bool:
    return isinstance(w, dict) and "q" in w


def _quantize_weight(w):
    """(..., K, N) weights -> (int8 (..., K, N), f32 scales (..., N)):
    symmetric, one scale per output channel (JAX `_qw`)."""
    w32 = w.float()
    s = torch.clamp(w32.abs().amax(dim=-2) / 127.0, min=1e-12)
    return torch.round(w32 / s[..., None, :]).to(torch.int8), s


def quantize_decoder_weights(params):
    """The decode loop's weight matrices as int8 ahead of the decode (JAX
    `decode.quantize_decoder_weights`): self-attention q/k/v/o,
    cross-attention q/o, both FFN matrices and the vocab and pointer heads
    become ``{"q": int8 (..., K, N), "s": f32 (..., N)}``; everything else
    stays as it is. "xla" and "mxu" decode such params directly."""
    def q(w):
        wq, s = _quantize_weight(w)
        return {"q": wq, "s": s}

    dec = dict(params["decoder"])
    for block, keys in (("self_attn", ("wq", "wk", "wv", "wo")),
                        ("cross_attn", ("wq", "wo")), ("ffn", ("w1", "w2"))):
        dec[block] = {k: q(v) if k in keys else v
                      for k, v in dec[block].items()}
    heads = {h: ({**p, "w": q(p["w"])} if h in ("vocab", "pointer") else p)
             for h, p in params["heads"].items()}
    return {**params, "decoder": dec, "heads": heads}


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


def _quantize_in_dtype(x):
    """Symmetric int8 over (Li, Dh) for each (layer, row, kv head) of x
    (L, B, Li, kvH, Dh), as `ops.cross_decode.quantize_rows(x, (2, 4))` but
    with the scale taken and kept in x's dtype (the JAX "xla" path's `_q`);
    returns (int8 values, scales (L, B, 1, kvH, 1) in x's dtype)."""
    scale = torch.clamp(x.abs().amax(dim=(2, 4), keepdim=True) / 127.0,
                        min=1e-8)
    return torch.round(x.float() / scale.float()).to(torch.int8), scale


def _head_mm(head, h_t):
    """h_t @ w + b, where an int8 w carries its per-column scale "s",
    applied to the product (JAX `_mixed_sample._head_mm`)."""
    y = h_t @ head["w"].to(h_t.dtype)
    if "s" in head:
        y = y * head["s"]
    return y + head["b"]


def _mixed_sample(heads, dims: ModelDims, struct, pos, h_t, h_cache,
                  output, attach, done, t):
    """Sampling tail of one step: mixed vocab ‖ pointer ‖ switch
    distribution and the greedy pointer-resolving argmax, with the
    reference quirks (eps-fill of illegal pointer slots, plain-vocab argmax
    for the first plank's 6 coords, first index on ties). Updates
    output/attach/done in place at column t."""
    S = dims.max_output_length
    vocab_logits = _head_mm(heads["vocab"], h_t)
    vocab_probs = torch.softmax(vocab_logits, dim=-1)
    feature = _head_mm(heads["pointer"], h_t)
    # a compute-dtype hidden cache promotes to f32, as jnp does
    pointer_logits = torch.einsum("bd,bsd->bs", feature,
                                  h_cache.to(feature.dtype))
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


def _check_impl(cross_impl, gqa_self_impl="auto"):
    if cross_impl not in IMPLS:
        raise ValueError(f"unknown cross_impl {cross_impl!r}; one of {IMPLS}")
    if gqa_self_impl not in GQA_SELF_IMPLS:
        raise ValueError(f"unknown gqa_self_impl {gqa_self_impl!r}; one of "
                         f"{GQA_SELF_IMPLS}")


@torch.no_grad()
def greedy_decode(params, batch: dict, dims: ModelDims,
                  compute_dtype=torch.bfloat16, early_exit=True,
                  kv_bucket=None, kv_quant=None, cross_impl="auto",
                  gqa_self_impl="auto", self_quant=None, weight_quant=False):
    """Batched greedy decode on the device of `batch`'s tensors. Returns
    samples (B, S) int32, attach (B, S) int32 (-1 = no pointer) and
    num_steps (int, steps executed)."""
    _check_impl(cross_impl, gqa_self_impl)
    inputs = {k: v for k, v in batch.items() if k.startswith("input")}
    inputs = _pad_or_crop(inputs, kv_bucket, dims)
    memory = encode(params, inputs, dims, compute_dtype=compute_dtype,
                    flash=True)
    # The JAX package pads memory to a multiple of 128 for its persistent
    # Pallas kernel (lane-aligned slices, decode.py:298-310); the CUDA
    # kernels take any width, so no pad is needed.
    return decode_from_memory(params, memory, inputs["input_mask"], dims,
                              compute_dtype=compute_dtype,
                              early_exit=early_exit, kv_quant=kv_quant,
                              cross_impl=cross_impl,
                              gqa_self_impl=gqa_self_impl,
                              self_quant=self_quant,
                              weight_quant=weight_quant)


@torch.no_grad()
def decode_from_memory(params, memory, memory_mask, dims: ModelDims,
                       compute_dtype=torch.bfloat16, early_exit=True,
                       kv_quant=None, cross_impl="auto",
                       gqa_self_impl="auto", self_quant=None,
                       weight_quant=False):
    """KV-cached greedy decode over encoder memory (B, Li, D) with its pad
    mask (B, Li) (True = pad), by the path `cross_impl` names (see the
    module docstring). kv_quant: int8 cross K/V (ignored by "persistent"
    and "fused", which always use it); self_quant: int8 self K/V, "mxu"
    only (None follows kv_quant); weight_quant: int8 decoder and head
    weights with one scale per output channel, "xla" and "mxu" only (the
    others warn and ignore it; weights from `quantize_decoder_weights`
    imply it, and the others raise on them); gqa_self_impl (grouped-query
    models): "expand" repeats K/V over each group, "grouped" contracts
    per (kv head, group), "auto" takes expand up to B=256."""
    _check_impl(cross_impl, gqa_self_impl)
    explicit_no_quant = kv_quant is False
    kv_quant = bool(kv_quant)
    prequantized = _is_prequantized(params["decoder"]["self_attn"]["wq"])
    if cross_impl == "auto":
        cross_impl = _pick_auto_impl(
            memory.device.type, dims, memory.shape[0], kv_quant=kv_quant,
            self_quant=bool(self_quant), weight_quant=weight_quant,
            prequantized=prequantized)
    if weight_quant and not prequantized and cross_impl not in ("mxu",
                                                                "xla"):
        warnings.warn(
            f"weight_quant is only implemented for the mxu/xla decode "
            f"paths; ignored with cross_impl={cross_impl!r}", stacklevel=2)
        weight_quant = False
    if prequantized:
        if cross_impl not in ("mxu", "xla"):
            raise ValueError(
                "pre-quantized decoder weights (quantize_decoder_weights) "
                f"require cross_impl 'mxu'/'xla', got {cross_impl!r}")
        weight_quant = True
    if gqa_self_impl == "auto":
        gqa_self_impl = "expand" if memory.shape[0] <= 256 else "grouped"
    if cross_impl == "persistent":
        from plankassembly_tpu_torch.ops.persistent_decode import (
            persistent_greedy_decode,
        )
        if explicit_no_quant or self_quant:
            warnings.warn(
                "cross_impl='persistent' has int8 cross-KV + compute-dtype "
                "self-KV semantics built in; kv_quant=False / "
                "self_quant=True are ignored", stacklevel=2)
        return persistent_greedy_decode(params, memory, memory_mask, dims,
                                        compute_dtype=compute_dtype,
                                        early_exit=early_exit)
    if cross_impl == "fused":
        dec = FusedDecode(params, memory, memory_mask, dims, compute_dtype)
        return dec.run(early_exit)
    return _decode_cached(params, memory, memory_mask, dims, compute_dtype,
                          early_exit, kv_quant, self_quant, cross_impl,
                          weight_quant, gqa_self_impl)


def _layers(tree, L):
    """Layer l's slice of each stacked leaf (an int8 weight's "q" and "s"
    too), for l < L."""
    def take(v, l):
        return {k: take(x, l) for k, x in v.items()} if isinstance(v, dict) \
            else v[l]
    return [{k: take(v, l) for k, v in tree.items()} for l in range(L)]


def _embed_step(emb, output, t, dof):
    """Decoder input at step t: zero at t = 0, else the previous token's
    value embedding plus its coordinate and plank-position embeddings."""
    if t == 0:
        return torch.zeros((output.shape[0], emb["value"].shape[1]),
                           dtype=emb["value"].dtype, device=output.device)
    prev = output[:, t - 1].long()
    return (emb["value"][prev] + emb["coord_out"][(t - 1) % dof][None]
            + emb["pos_out"][(t - 1) // dof][None])


def _run_steps(step, S, early_exit, done, output, attach):
    """Run step(t) for t = 0, 1, ... until every row is done, as JAX's
    while_loop does, and return the number of steps it runs. The host reads
    the done flags only every CHECK_EVERY steps; steps run past the exit
    only write columns from the exit on, which are reset here."""
    n = torch.full((), S, dtype=torch.int64, device=done.device)
    t = 0
    while t < S:
        step(t)
        t += 1
        if early_exit:
            n = torch.where((n == S) & done.all(), t, n)
            if t % CHECK_EVERY == 0 and t < S and bool(done.all()):
                break
    if not early_exit:
        return S
    n = int(n)
    output[:, n:] = 0
    attach[:, n:] = -1
    return n


def _decode_cached(params, memory, memory_mask, dims: ModelDims, cd,
                   early_exit, kv_quant, self_quant, cross_impl,
                   weight_quant=False, gqa_self_impl="expand"):
    """The JAX package's general cached loop (`decode_from_memory` with
    cross_impl "xla", "mxu" or "kernel"), operation for operation: products
    in the compute dtype with f32 scores and weights, the residual stream,
    layer norms and heads in f32. With `weight_quant` each product takes
    the int8 weight cast to the compute dtype and scales its output per
    column, in the compute dtype (JAX's order)."""
    use_kernel = cross_impl == "kernel"
    use_mxu = cross_impl == "mxu"
    S, H, Dh, D = (dims.max_output_length, dims.num_head, dims.head_dim,
                   dims.num_model)
    kvH, G, L = dims.kv_heads, dims.kv_groups, dims.num_decoder_layers
    Dkv = kvH * Dh
    if use_kernel and G > 1:
        # the kernel takes one K/V row per query head; grouped-query
        # models take the mxu schedule on the GPU (JAX: on its TPU)
        use_kernel = False
        use_mxu = memory.device.type == "cuda"
    dev = memory.device
    B, Li = memory.shape[0], memory.shape[1]
    head_kv = torch.arange(H, device=dev) // G
    bias_f = torch.where(memory_mask.to(dev), NEG_INF, 0.0).float()  # (B, Li)

    cross_k, cross_v = precompute_cross_kv(params, memory, dims, cd)
    ck_s = cv_s = None
    if use_kernel:
        # one (Li, Dh) K and V tile per (row, head), see ops/cross_decode.py
        ck = cross_k.permute(0, 1, 3, 2, 4).reshape(L, B * H, Li, Dh)
        cv = cross_v.permute(0, 1, 3, 2, 4).reshape(L, B * H, Li, Dh)
        bias_bh = bias_f[:, None, :].expand(B, H, Li).reshape(B * H, Li)
        if kv_quant:
            ck, ck_s = CD.quantize_rows(ck, (2, 3))
            cv, cv_s = CD.quantize_rows(cv, (2, 3))
            ck_s, cv_s = ck_s.reshape(L, B * H, 1), cv_s.reshape(L, B * H, 1)
        ck, cv, bias_bh = ck.contiguous(), cv.contiguous(), \
            bias_bh.contiguous()
    elif use_mxu:
        # queries as the block-diagonal rows of an (H, Dkv) matrix against
        # the unsplit K/V; each head keeps its diagonal Dh block of the output
        k_flat = cross_k.reshape(L, B, Li, Dkv)
        v_flat = cross_v.reshape(L, B, Li, Dkv)
        if kv_quant:
            k4q, ck_s = CD.quantize_rows(cross_k, (2, 4))
            v4q, cv_s = CD.quantize_rows(cross_v, (2, 4))
            k_flat, v_flat = (k4q.reshape(L, B, Li, Dkv),
                              v4q.reshape(L, B, Li, Dkv))
            ck_s, cv_s = ck_s.reshape(L, B, kvH), cv_s.reshape(L, B, kvH)
        eye_h = (head_kv[:, None] == torch.arange(kvH, device=dev)[None]
                 ).float()                                    # (H, kvH)
        bias_b = bias_f[:, None, :]                           # (B, 1, Li)
    elif kv_quant:
        ck_q, ck_s = _quantize_in_dtype(cross_k)
        cv_q, cv_s = _quantize_in_dtype(cross_v)
    cross_bias = bias_f[:, None, None, :]

    dec, heads, emb = params["decoder"], params["heads"], params["embed"]
    n1_l, n2_l, n3_l = (_layers(dec[n], L) for n in ("norm1", "norm2", "norm3"))
    mats = _decode_weights(dec, L, cd, weight_quant)
    if weight_quant:
        heads = _quantized_heads(heads, cd)

    def scores_of(q, k):  # q (B,1,H,Dh), k (B,T,kvH,Dh) -> (B,H,1,T) f32
        if G > 1 and gqa_self_impl == "grouped":
            s = torch.einsum("bqngd,bknd->bngqk",
                             q.float().reshape(B, 1, kvH, G, Dh), k.float())
            return s.reshape(B, H, 1, -1)
        k = k.repeat_interleave(G, dim=2) if G > 1 else k
        return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())

    def out_of(w, v):  # w (B,H,1,T) cd, v (B,T,kvH,Dh) -> (B,1,H,Dh) f32
        if G > 1 and gqa_self_impl == "grouped":
            o = torch.einsum("bngqk,bknd->bqngd",
                             w.float().reshape(B, kvH, G, 1, -1), v.float())
            return o.reshape(B, 1, H, Dh)
        v = v.repeat_interleave(G, dim=2) if G > 1 else v
        return torch.einsum("bhqk,bkhd->bqhd", w.float(), v.float())

    struct = torch.as_tensor(pointer_structure_mask(dims), device=dev)
    scale = 1.0 / math.sqrt(Dh)
    self_quant = bool(kv_quant if self_quant is None else self_quant) \
        and use_mxu
    cache_dtype = torch.int8 if self_quant else cd
    k_cache = torch.zeros((L, B, S, kvH, Dh), dtype=cache_dtype, device=dev)
    v_cache = torch.zeros((L, B, S, kvH, Dh), dtype=cache_dtype, device=dev)
    if self_quant:
        ks_cache = torch.zeros((L, B, S, kvH), dtype=torch.float32,
                               device=dev)
        vs_cache = torch.zeros((L, B, S, kvH), dtype=torch.float32,
                               device=dev)
    h_cache = torch.zeros((B, S, D), dtype=cd if use_mxu else torch.float32,
                          device=dev)
    output = torch.zeros((B, S), dtype=torch.int32, device=dev)
    attach = torch.full((B, S), -1, dtype=torch.int32, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    pos = torch.arange(S, device=dev)

    def quant_token(x):  # (B, kvH, Dh) -> int8, (B, kvH) f32
        q, s = CD.quantize_rows(x, (-1,))
        return q, s[..., 0]

    def cross(l, q2):
        if use_kernel:
            c = CD.cross_attn_decode(
                q2.reshape(B * H, Dh), ck[l], cv[l], bias_bh,
                None if ck_s is None else ck_s[l],
                None if cv_s is None else cv_s[l], sm_scale=scale)
        elif use_mxu:
            qh = q2[:, 0].float()                             # (B, H, Dh)
            if ck_s is not None:
                qh = qh * ck_s[l][:, head_kv][..., None]       # K dequant
            qblk = (qh[:, :, None, :] * eye_h[None, :, :, None]
                    ).reshape(B, H, Dkv)
            sc = torch.einsum("bhe,ble->bhl", qblk.to(cd).float(),
                              k_flat[l].to(cd).float()) * scale
            w = torch.softmax(sc + bias_b, dim=-1)            # (B, H, Li)
            of = torch.einsum("bhl,ble->bhe", w.to(cd).float(),
                              v_flat[l].to(cd).float())
            c = (of.reshape(B, H, kvH, Dh)
                 * eye_h[None, :, :, None]).sum(dim=2)        # (B, H, Dh)
            if cv_s is not None:
                c = c * cv_s[l][:, head_kv][..., None]
        else:
            if kv_quant:
                ckl = ck_q[l].to(cd) * ck_s[l].to(cd)
                cvl = cv_q[l].to(cd) * cv_s[l].to(cd)
            else:
                ckl, cvl = cross_k[l], cross_v[l]
            w = torch.softmax(scores_of(q2, ckl) * scale + cross_bias, -1)
            c = out_of(w.to(cd), cvl)
        return c.reshape(B, 1, D)

    def step(t):
        x = _embed_step(emb, output, t, dims.num_output_dof)[:, None, :]
        self_bias = torch.where(pos <= t, 0.0, NEG_INF)[None, None, None, :]
        for l in range(L):
            h = layer_norm(n1_l[l], x)
            qkv = _product(h, mats[l]["qkv"], cd)[:, 0]
            q = qkv[:, :D].reshape(B, 1, H, Dh)
            k_t = qkv[:, D:D + Dkv].reshape(B, kvH, Dh)
            v_t = qkv[:, D + Dkv:].reshape(B, kvH, Dh)
            if self_quant:
                k_cache[l, :, t], ks_cache[l, :, t] = quant_token(k_t)
                v_cache[l, :, t], vs_cache[l, :, t] = quant_token(v_t)
                scores = scores_of(q, k_cache[l].to(cd)) * scale
                # per-token scales of each query head's kv head: the K
                # scale multiplies the scores, the V scale the weights
                ks_t = ks_cache[l].transpose(1, 2)[:, head_kv]   # (B, H, S)
                vs_t = vs_cache[l].transpose(1, 2)[:, head_kv]
                w = torch.softmax(scores * ks_t[:, :, None, :] + self_bias,
                                  dim=-1)
                a = out_of((w * vs_t[:, :, None, :]).to(cd),
                           v_cache[l].to(cd))
            else:
                k_cache[l, :, t] = k_t
                v_cache[l, :, t] = v_t
                w = torch.softmax(scores_of(q, k_cache[l]) * scale
                                  + self_bias, dim=-1)
                a = out_of(w.to(cd), v_cache[l])
            a = _product(a.reshape(B, 1, D), mats[l]["wo"], cd)
            x = x + a.to(x.dtype)

            h = layer_norm(n2_l[l], x)
            q2 = _product(h, mats[l]["cwq"], cd).reshape(B, 1, H, Dh)
            c = _product(cross(l, q2), mats[l]["cwo"], cd)
            x = x + c.to(x.dtype)

            h = layer_norm(n3_l[l], x)
            z = torch.relu(_product(h, mats[l]["w1"], cd))
            z = _product(z, mats[l]["w2"], cd)
            x = x + z.to(x.dtype)

        h_t = layer_norm(dec["final_norm"], x)[:, 0].float()
        h_cache[:, t] = h_t.to(h_cache.dtype)
        _mixed_sample(heads, dims, struct, pos, h_t, h_cache, output, attach,
                      done, t)

    n = _run_steps(step, S, early_exit, done, output, attach)
    return {"samples": output, "attach": attach, "num_steps": n}


def _weight_form(w, cd, weight_quant):
    """(weight, column scales or None) as a product of the decode loop
    takes it: int8 and its scales under weight quantization (already so
    in weights from `quantize_decoder_weights`), else w in the compute
    dtype, cast once rather than at every step."""
    if _is_prequantized(w):
        return w["q"], w["s"]
    if weight_quant:
        return _quantize_weight(w)
    return w.to(cd), None


def _product(x, wsb, cd):
    """x @ w + b in the compute dtype, wsb = (w, column scales or None, b):
    an int8 w's scales multiply the product before the bias (JAX `_mm`)."""
    w, s, b = wsb
    y = x.to(cd) @ w.to(cd)
    if s is not None:
        y = y * s.to(cd)
    return y + b


def _quantized_heads(heads, cd):
    """The heads with int8 vocab and pointer matrices and their scales
    ("s"), as `_head_mm` takes them."""
    heads = dict(heads)
    for h in ("vocab", "pointer"):
        w, s = _weight_form(heads[h]["w"], cd, True)
        heads[h] = {**heads[h], "w": w, "s": s}
    return heads


def _decode_weights(dec, L, cd, weight_quant):
    """Per layer, the decode loop's products as (weight, column scales or
    None, bias in the compute dtype), cast once rather than at every step:
    "qkv" (the fused QKV, quantized from the f32 concatenation, or the
    int8 blocks and scales of pre-quantized q/k/v concatenated:
    per-column quantization commutes with concatenating columns), "wo",
    "cwq", "cwo", "w1", "w2"."""
    out = []
    for sa, ca, f in zip(*(_layers(dec[n], L)
                           for n in ("self_attn", "cross_attn", "ffn"))):
        qkv = ("wq", "wk", "wv")
        if _is_prequantized(sa["wq"]):
            w, s = (torch.cat([sa[k]["q"] for k in qkv], dim=1),
                    torch.cat([sa[k]["s"] for k in qkv]))
        else:
            w, s = _weight_form(torch.cat([sa[k] for k in qkv], dim=1), cd,
                                weight_quant)
        bqkv = torch.cat([sa["bq"], sa["bk"], sa["bv"]]).to(cd)
        out.append({"qkv": (w, s, bqkv), **{
            name: (*_weight_form(blk[wk], cd, weight_quant), blk[bk].to(cd))
            for name, blk, wk, bk in (("wo", sa, "wo", "bo"),
                                      ("cwq", ca, "wq", "bq"),
                                      ("cwo", ca, "wo", "bo"),
                                      ("w1", f, "w1", "b1"),
                                      ("w2", f, "w2", "b2"))}})
    return out


class FusedDecode:
    """The "fused" decode loop (the JAX package's `_decode_fused`): its
    per-layer weights, int8 cross K/V and caches in the layouts of
    `ops/fused_decode.py`, and its outputs. `step(t)` runs one decode
    step; `embed`, `layer` and `layer_args` expose a step's parts."""

    def __init__(self, params, memory, memory_mask, dims: ModelDims, cd):
        H, Dh, D = dims.num_head, dims.head_dim, dims.num_model
        if dims.kv_heads != H:
            raise ValueError(
                "cross_impl='fused' requires MHA "
                f"(H={H}, kvH={dims.kv_heads}); use cross_impl='mxu' for "
                "GQA/MQA")
        B, Li = memory.shape[0], memory.shape[1]
        CH = FD.chunk_width(Li)
        if Li % CH:
            raise ValueError(f"fused decode needs Li % {CH} == 0, got {Li}")
        L, S = dims.num_decoder_layers, dims.max_output_length
        dev, f32 = memory.device, torch.float32
        self.dims, self.cd, self.B = dims, cd, B
        self.scale = 1.0 / math.sqrt(Dh)

        cross_k, cross_v = precompute_cross_kv(params, memory, dims, cd)
        k4q, cks = CD.quantize_rows(cross_k, (2, 4))      # (L, B, Li, H, Dh)
        v4q, cvs = CD.quantize_rows(cross_v, (2, 4))
        del cross_k, cross_v
        self.ck = [k4q[l].permute(0, 2, 1, 3).contiguous() for l in range(L)]
        self.cv = [v4q[l].permute(0, 2, 3, 1).contiguous() for l in range(L)]
        self.cks = [cks[l].reshape(B, H).contiguous() for l in range(L)]
        self.cvs = [cvs[l].reshape(B, H).contiguous() for l in range(L)]
        self.cbias = torch.where(memory_mask.to(dev), NEG_INF, 0.0).to(f32)

        dec = params["decoder"]
        sa, ca, ffn = (_layers(dec[n], L) for n in
                       ("self_attn", "cross_attn", "ffn"))
        norms = [_layers(dec[n], L) for n in ("norm1", "norm2", "norm3")]

        def c(t, dtype):
            return t.to(device=dev, dtype=dtype).contiguous()

        self.weights = [(
            c(torch.cat([sa[l]["wq"], sa[l]["wk"], sa[l]["wv"]], dim=1), cd),
            c(torch.cat([sa[l]["bq"], sa[l]["bk"], sa[l]["bv"]]), f32),
            c(sa[l]["wo"], cd), c(sa[l]["bo"], f32),
            c(ca[l]["wq"], cd), c(ca[l]["bq"], f32),
            c(ca[l]["wo"], cd), c(ca[l]["bo"], f32),
            c(ffn[l]["w1"], cd), c(ffn[l]["b1"], f32),
            c(ffn[l]["w2"], cd), c(ffn[l]["b2"], f32),
            c(torch.stack([n[l][k] for n in norms for k in ("scale", "bias")]),
              f32)) for l in range(L)]
        self.final_norm, self.heads = dec["final_norm"], params["heads"]
        self.emb = params["embed"]

        self.k_cache = [torch.zeros((B, H, S, Dh), dtype=torch.int8,
                                    device=dev) for _ in range(L)]
        self.v_cache = [torch.zeros((B, H, Dh, S), dtype=torch.int8,
                                    device=dev) for _ in range(L)]
        self.ks_cache = [torch.zeros((B, H, S), dtype=f32, device=dev)
                         for _ in range(L)]
        self.vs_cache = [torch.zeros((B, H, S), dtype=f32, device=dev)
                         for _ in range(L)]
        self.h_cache = torch.zeros((B, S, D), dtype=cd, device=dev)
        self.output = torch.zeros((B, S), dtype=torch.int32, device=dev)
        self.attach = torch.full((B, S), -1, dtype=torch.int32, device=dev)
        self.done = torch.zeros((B,), dtype=torch.bool, device=dev)
        self.struct = torch.as_tensor(pointer_structure_mask(dims), device=dev)
        self.pos = torch.arange(S, device=dev)

    def embed(self, t):
        return _embed_step(self.emb, self.output, t,
                           self.dims.num_output_dof).float()

    def layer_args(self, l):
        """Layer l's arguments of `fused_decoder_layer` after (x, t)."""
        return (*self.weights[l], self.k_cache[l], self.v_cache[l],
                self.ks_cache[l], self.vs_cache[l], self.ck[l], self.cv[l],
                self.cks[l], self.cvs[l], self.cbias)

    def layer(self, l, x, t):
        """Run layer l at step t and write the new token's K/V at t."""
        d = self.dims
        x, nk, nv, nks, nvs = FD.fused_decoder_layer(
            x, t, *self.layer_args(l), H=d.num_head, Dh=d.head_dim,
            sm_scale=self.scale, cd=self.cd)
        B, H, Dh = self.B, d.num_head, d.head_dim
        self.k_cache[l][:, :, t] = nk.reshape(B, H, Dh)
        self.v_cache[l][:, :, :, t] = nv.reshape(B, H, Dh)
        self.ks_cache[l][:, :, t] = nks
        self.vs_cache[l][:, :, t] = nvs
        return x

    def step(self, t):
        x = self.embed(t)
        for l in range(self.dims.num_decoder_layers):
            x = self.layer(l, x, t)
        h_t = layer_norm(self.final_norm, x).float()
        self.h_cache[:, t] = h_t.to(self.cd)
        _mixed_sample(self.heads, self.dims, self.struct, self.pos, h_t,
                      self.h_cache, self.output, self.attach, self.done, t)

    def run(self, early_exit=True):
        n = _run_steps(self.step, self.dims.max_output_length, early_exit,
                       self.done, self.output, self.attach)
        return {"samples": self.output, "attach": self.attach, "num_steps": n}


@torch.no_grad()
def greedy_decode_nocache(params, batch: dict, dims: ModelDims,
                          compute_dtype=torch.bfloat16, early_exit=True):
    """Greedy decode with no KV cache (JAX `decode.greedy_decode_nocache`,
    the reference's eval loop): each step embeds the whole prefix and runs
    the full decoder stack over S positions, keys past step t masked, and
    samples row t. The parity oracle of the cached paths and the baseline
    a benchmark measures them against. The encoder runs `flash_attention`;
    the host reads the done flags every CHECK_EVERY steps."""
    cd = compute_dtype
    S = dims.max_output_length
    inputs = {k: v for k, v in batch.items() if k.startswith("input")}
    memory = encode(params, inputs, dims, compute_dtype=cd, flash=True)
    dev = memory.device
    B = memory.shape[0]
    struct = torch.as_tensor(pointer_structure_mask(dims), device=dev)
    cross_bias = torch.where(inputs["input_mask"], NEG_INF, 0.0).float()[
        :, None, None, :]
    pos = torch.arange(S, device=dev)
    causal = torch.where(pos[None, :] <= pos[:, None], 0.0, NEG_INF)[None,
                                                                    None]
    output = torch.zeros((B, S), dtype=torch.int32, device=dev)
    attach = torch.full((B, S), -1, dtype=torch.int32, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)

    def step(t):
        # rows past t are computed from a garbage prefix; they are masked
        # as keys and never read
        x = embed_output(params, output[:, :S - 1], dims)
        prefix = torch.where(pos <= t, 0.0, NEG_INF)[None, None, None, :]
        hiddens = decode_stack(params, x, memory, causal + prefix, cross_bias,
                               dims, compute_dtype=cd).float()
        _mixed_sample(params["heads"], dims, struct, pos, hiddens[:, t],
                      hiddens, output, attach, done, t)

    n = _run_steps(step, S, early_exit, done, output, attach)
    return {"samples": output, "attach": attach, "num_steps": n}


def eval_step(params, batch: dict, dims: ModelDims,
              compute_dtype=torch.bfloat16) -> dict:
    """The reference's eval step (JAX `decode.eval_step`): greedy decode
    (the default path) at the batch's kv bucket, then the host parse.
    batch: input streams and `output_value` as tensors on one device.
    Returns numpy samples/attach, num_steps and per-row (P, 6) lists
    `predicts` / `groundtruths`."""
    inputs = {k: v for k, v in batch.items() if k.startswith("input")}
    out = greedy_decode(params, inputs, dims, compute_dtype=compute_dtype,
                        kv_bucket=pick_kv_bucket(inputs["input_mask"]))
    samples = out["samples"].cpu().numpy()
    gts = np.asarray(batch["output_value"].cpu())
    return {"samples": samples, "attach": out["attach"].cpu().numpy(),
            "num_steps": int(out["num_steps"]),
            "predicts": [parse_sequence(r, dims) for r in samples],
            "groundtruths": [parse_sequence(r, dims) for r in gts]}


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
