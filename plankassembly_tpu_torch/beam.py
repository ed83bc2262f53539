"""Beam-search decode over the mixed vocab ‖ pointer ‖ switch distribution
(a port of `plankassembly_tpu/beam.py`).

Each program keeps `num_beams` hypotheses scored under the distribution the
greedy path samples from (`decode._mixed_sample`: the eps-filled pointer
slots, the plain-vocab first plank, pointers only to j <= t). With
num_beams=1 it reproduces the greedy decode's tokens up to each row's END.

- Beams are an expanded batch of B*K rows (program-major, beam-minor) for
  every per-step tensor, but the encoder memory and the cross-attention
  K/V stay per program (B rows): each step's cross product contracts the
  (B, K, H, Dh) queries against them, so the K/V stream does not grow
  with the beam width.
- Reordering the beams is a gather over the beam axis of the self K/V and
  pointer h caches, the outputs and the flags.
- The top K of each program's (parent beam x candidate) scores come from a
  stable descending sort, so ties go to the lower flat index, as
  `jax.lax.top_k` breaks them (eps-filled pointer slots and masked
  candidates make exact ties common).
- Scores are cumulative log-probs; a finished beam is frozen by a PAD
  continuation at log-prob 0. The result is each program's best finished
  beam (the best unfinished one if none finished) under GNMT's length
  normalization score / ((5 + len) / 6) ** alpha (alpha 0: the sum).

The products stay `torch.matmul` / `einsum`, as the JAX package computes
them outside any Pallas kernel; the encoder runs `flash_attention`.
"""
from __future__ import annotations

import math

import torch

from plankassembly_tpu_torch.config import ModelDims
from plankassembly_tpu_torch.decode import (
    EPS, _decode_weights, _head_mm, _is_prequantized, _layers, _product,
    _quantized_heads, _run_steps, precompute_cross_kv,
)
from plankassembly_tpu_torch.models.model import (
    NEG_INF, encode, layer_norm, pointer_structure_mask,
)

_TINY = 1e-30   # probability floor before the log (eps slots stay eligible)
_NEG = -1e9     # a finite -inf: 128 steps of real log-probs stay > -1e4


@torch.no_grad()
def beam_decode(params, batch: dict, dims: ModelDims, num_beams: int = 4,
                compute_dtype=torch.bfloat16, alpha: float = 0.0,
                kv_bucket=None, early_exit=True, weight_quant=False):
    """Batched beam-search decode on the device of `batch`'s tensors.
    `kv_bucket` crops the packed inputs (never pads, as in JAX). Returns
    samples / attach (B, S) of each program's best beam, num_steps (int),
    beam_scores (B, K) f32 (length-normalized), and beam_samples /
    beam_attach (B, K, S), every hypothesis."""
    inputs = {k: v for k, v in batch.items() if k.startswith("input")}
    if kv_bucket is not None and kv_bucket < inputs["input_value"].shape[1]:
        inputs = {k: v[:, :kv_bucket] for k, v in inputs.items()}
    memory = encode(params, inputs, dims, compute_dtype=compute_dtype,
                    flash=True)
    return beam_decode_from_memory(
        params, memory, inputs["input_mask"], dims, num_beams=num_beams,
        compute_dtype=compute_dtype, alpha=alpha, early_exit=early_exit,
        weight_quant=weight_quant)


def _topk_first_index(x, k):
    """The k largest entries of each row of x and their indices, ties to
    the lower index (`jax.lax.top_k`'s order, which `torch.topk` does not
    promise on CUDA)."""
    values, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return values[:, :k], idx[:, :k]


@torch.no_grad()
def beam_decode_from_memory(params, memory, memory_mask, dims: ModelDims,
                            num_beams: int = 4, compute_dtype=torch.bfloat16,
                            alpha: float = 0.0, early_exit=True,
                            weight_quant=False):
    """Beam search over encoder memory (B, Li, D) with its pad mask
    (B, Li) (True = pad); see `beam_decode`. Weights from
    `decode.quantize_decoder_weights` imply weight_quant."""
    cd, K = compute_dtype, num_beams
    S, H, Dh, D = (dims.max_output_length, dims.num_head, dims.head_dim,
                   dims.num_model)
    kvH, G, L = dims.kv_heads, dims.kv_groups, dims.num_decoder_layers
    Dkv, dof, V = kvH * Dh, dims.num_output_dof, dims.vocab_size
    PAD, C = dims.end + 1, dims.vocab_size + S
    dev = memory.device
    B = memory.shape[0]
    BK = B * K

    # cross K/V per program: (L, B, Li, kvH, Dh)
    cross_k, cross_v = precompute_cross_kv(params, memory, dims, cd)
    cross_bias = torch.where(memory_mask.to(dev), NEG_INF, 0.0).float()

    dec, heads, emb = params["decoder"], params["heads"], params["embed"]
    n1_l, n2_l, n3_l = (_layers(dec[n], L) for n in ("norm1", "norm2", "norm3"))
    weight_quant = weight_quant or _is_prequantized(dec["self_attn"]["wq"])
    mats = _decode_weights(dec, L, cd, weight_quant)
    if weight_quant:
        heads = _quantized_heads(heads, cd)

    def expand(kv):  # (rows, n, kvH, Dh) -> (rows, n, H, Dh) f32
        kv = kv.float()
        return kv.repeat_interleave(G, dim=2) if G > 1 else kv

    struct = torch.as_tensor(pointer_structure_mask(dims), device=dev)
    scale = 1.0 / math.sqrt(Dh)
    pos = torch.arange(S, device=dev)
    k_cache = torch.zeros((L, BK, S, kvH, Dh), dtype=cd, device=dev)
    v_cache = torch.zeros((L, BK, S, kvH, Dh), dtype=cd, device=dev)
    h_cache = torch.zeros((BK, S, D), dtype=torch.float32, device=dev)
    output = torch.zeros((BK, S), dtype=torch.int32, device=dev)
    attach = torch.full((BK, S), -1, dtype=torch.int32, device=dev)
    done = torch.zeros((B, K), dtype=torch.bool, device=dev)
    length = torch.zeros((B, K), dtype=torch.int32, device=dev)
    # only beam 0 is live at t = 0: the K beams start identical, and the
    # first top K would otherwise take K copies of one continuation
    scores = torch.full((B, K), _NEG, dtype=torch.float32, device=dev)
    scores[:, 0] = 0.0
    pad_row = torch.full((C,), _NEG, dtype=torch.float32, device=dev)
    pad_row[PAD] = 0.0
    rows = torch.arange(B, device=dev)[:, None]

    def step(t):
        if t == 0:
            x = torch.zeros((BK, 1, D), dtype=emb["value"].dtype, device=dev)
        else:
            prev = output[:, t - 1].long()
            x = (emb["value"][prev] + emb["coord_out"][(t - 1) % dof][None]
                 + emb["pos_out"][(t - 1) // dof][None])[:, None, :]
        self_bias = torch.where(pos <= t, 0.0, NEG_INF)[None, None, None, :]
        for l in range(L):
            h = layer_norm(n1_l[l], x)
            qkv = _product(h, mats[l]["qkv"], cd)[:, 0]
            q = qkv[:, :D].reshape(BK, 1, H, Dh)
            k_cache[l, :, t] = qkv[:, D:D + Dkv].reshape(BK, kvH, Dh)
            v_cache[l, :, t] = qkv[:, D + Dkv:].reshape(BK, kvH, Dh)
            sc = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                              expand(k_cache[l])) * scale
            w = torch.softmax(sc + self_bias, dim=-1)
            a = torch.einsum("bhqk,bkhd->bqhd", w.to(cd).float(),
                             expand(v_cache[l]))
            a = _product(a.reshape(BK, 1, D), mats[l]["wo"], cd)
            x = x + a.to(x.dtype)

            # per-beam queries against per-program K/V, grouped by kv head
            h = layer_norm(n2_l[l], x)
            q2 = _product(h, mats[l]["cwq"], cd)[:, 0]
            qk = q2.float().reshape(B, K, kvH, G, Dh)
            sc = torch.einsum("bkngd,blnd->bkngl", qk,
                              cross_k[l].float()) * scale
            w = torch.softmax(sc + cross_bias[:, None, None, None, :], -1)
            c = torch.einsum("bkngl,blnd->bkngd", w.to(cd).float(),
                             cross_v[l].float())
            c = _product(c.reshape(BK, 1, D), mats[l]["cwo"], cd)
            x = x + c.to(x.dtype)

            h = layer_norm(n3_l[l], x)
            z = torch.relu(_product(h, mats[l]["w1"], cd))
            z = _product(z, mats[l]["w2"], cd)
            x = x + z.to(x.dtype)

        h_t = layer_norm(dec["final_norm"], x)[:, 0].float()
        h_cache[:, t] = h_t

        # log-probs of every candidate (the _mixed_sample distribution)
        vocab_logits = _head_mm(heads["vocab"], h_t)
        if t + 1 < dof:  # first plank: the plain vocab distribution
            logp = torch.cat([torch.log_softmax(vocab_logits, dim=-1),
                              torch.full((BK, S), _NEG, device=dev)], -1)
        else:
            feature = _head_mm(heads["pointer"], h_t)
            pointer_logits = torch.einsum("bd,bsd->bs", feature,
                                          h_cache) / D
            prob = torch.sigmoid(h_t @ heads["switch"]["w"]
                                 + heads["switch"]["b"])
            triu_bias = torch.where(pos >= t, NEG_INF, 0.0)[None, :]
            pointer_probs = torch.softmax(pointer_logits + triu_bias,
                                          dim=-1) * prob
            pointer_probs = torch.where(
                struct[t][None, :] == 0, torch.tensor(EPS, device=dev),
                pointer_probs)
            mixed = torch.cat([torch.softmax(vocab_logits, dim=-1)
                               * (1 - prob), pointer_probs], dim=-1)
            logp = torch.log(torch.clamp(mixed, min=_TINY))
            logp[:, V:] = torch.where(pos[None, :] > t,
                                      torch.tensor(_NEG, device=dev),
                                      logp[:, V:])
        # a finished beam continues with PAD at no cost
        logp = torch.where(done.reshape(BK)[:, None], pad_row[None, :], logp)

        cand = scores[:, :, None] + logp.reshape(B, K, C)
        top, flat = _topk_first_index(cand.reshape(B, K * C), K)
        scores.copy_(top)
        parent, choice = flat // C, (flat % C).reshape(BK)
        for buf in (output, attach, h_cache):
            buf.copy_(buf.reshape(B, K, *buf.shape[1:])[rows, parent]
                      .reshape(buf.shape))
        for cache in (k_cache, v_cache):
            cache.copy_(cache.reshape(L, B, K, S, kvH, Dh)[:, rows, parent]
                        .reshape(cache.shape))
        done.copy_(torch.gather(done, 1, parent))
        length.copy_(torch.gather(length, 1, parent))

        is_ptr = choice >= V
        ptr = torch.clamp(choice - V, 0, S - 1)
        copied = torch.gather(output, 1, ptr[:, None])[:, 0]
        token = torch.where(is_ptr, copied, choice.to(torch.int32))
        output[:, t] = token
        attach[:, t] = torch.where(is_ptr, ptr, -1).to(torch.int32)
        length.add_((~done).to(torch.int32))
        done.logical_or_(token.reshape(B, K) == dims.end)

    # Once every beam is done a step keeps the beams in order (each takes
    # its PAD continuation at +0, and the stable sort keeps equal scores in
    # parent order), so steps run past the exit only write later columns,
    # which _run_steps resets
    n = _run_steps(step, S, early_exit, done, output, attach)

    if alpha:
        norm = scores / ((5.0 + length.float()) / 6.0) ** alpha
    else:
        norm = scores
    any_done = done.any(dim=1, keepdim=True)
    sel = torch.where(any_done & ~done, torch.tensor(_NEG, device=dev), norm)
    best = torch.argmax(sel, dim=1)
    out_bk, att_bk = output.reshape(B, K, S), attach.reshape(B, K, S)
    return {"samples": out_bk[rows[:, 0], best],
            "attach": att_bk[rows[:, 0], best], "num_steps": n,
            "beam_scores": norm, "beam_samples": out_bk,
            "beam_attach": att_bk}
