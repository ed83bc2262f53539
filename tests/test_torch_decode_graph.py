"""The redesigned CUDA decode loop (`csrc/decode.cu`,
`ops/persistent_decode.py`), checked on the CPU where the kernels cannot
run:

- the ctypes mirror `DecodeArgs` against `struct DecodeArgs` parsed from
  the CUDA source, names, kinds and order;
- the GQA cross-attention's schedule, emulated in plain PyTorch: spans of
  64 keys dealt round robin to the ranks of a cluster, a span with no real
  key skipped (any mask), each kept span read once for every query head of
  the group, one online softmax per head over a rank's spans, the ranks'
  (m, l, o) combined in rank order; held against the plain version's
  cross-attention and the Pallas kernel in interpret mode;
- `_prepare`: the state and scratch the kernels read, without the split-K
  workspaces and counters of the earlier design.

The CUDA kernels themselves run only on the GPU (`chip_smoke.py` decode,
serve and fit hold them against the plain version)."""
import ctypes
import dataclasses
import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plankassembly_tpu.models.model import ModelDims as JaxDims, init_params
from plankassembly_tpu.ops.cross_decode import (
    cross_attn_decode as jax_cross_attn_decode,
)
from plankassembly_tpu_torch.checkpoint import params_from_jax
from plankassembly_tpu_torch.config import ModelDims
from plankassembly_tpu_torch.ops import persistent_decode as PD
from plankassembly_tpu_torch.ops.cross_decode import quantize_rows
from tests.tiny import tiny_config

DECODE_CU = os.path.join(os.path.dirname(PD.__file__), os.pardir, "csrc",
                         "decode.cu")
SPAN = 64          # kSpan in csrc/decode.cu
NEG_INF = -1e9
# the schedule adds the same f32 terms in another order, and folds the
# K scale into the scores
TOL = 1e-6


# ------------------------------------------------------------ the mirror
def _struct_fields(src):
    """[(name, "int" | "ptr")] of `struct DecodeArgs` in the CUDA source."""
    body = re.search(r"struct DecodeArgs \{(.*?)\n\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = []
    for decl in body.split(";"):
        decl = " ".join(decl.split())
        if not decl:
            continue
        m = re.fullmatch(r"(const )?([A-Za-z_0-9 ]+?)\s*(\*?)\s*(\w+)", decl)
        assert m is not None, decl
        kind = "ptr" if m.group(3) else "int"
        if kind == "int":
            assert m.group(2) == "long long", decl
        fields.append((m.group(4), kind))
    return fields


def test_decode_args_mirror_matches_the_cuda_struct():
    with open(DECODE_CU) as f:
        want = _struct_fields(f.read())
    got = [(n, "ptr" if t is ctypes.c_void_p else "int")
           for n, t in PD.DecodeArgs._fields_]
    assert got == want
    assert ctypes.sizeof(PD.DecodeArgs) == 8 * len(want)


# ---------------------------------------------- GQA cross-attention schedule
def cluster_ranks(Li, ranks):
    """Ranks of a (row, kv head)'s cluster: min(ranks, spans)."""
    return min(ranks, -(-Li // SPAN))


def span_schedule(pad_row, ranks):
    """The spans each rank of one row's cluster reads, as csrc/decode.cu's
    cross kernel deals them: rank r keeps the spans r, r + CL, ... that
    hold a real key (all of them when the row has none), in that order.
    Returns {rank: [span, ...]}."""
    Li = pad_row.shape[0]
    nsp = -(-Li // SPAN)
    CL = cluster_ranks(Li, ranks)
    real = [bool((~pad_row[z * SPAN:(z + 1) * SPAN]).any())
            for z in range(nsp)]
    any_real = any(real)
    return {r: [z for z in range(r, nsp, CL) if real[z] or not any_real]
            for r in range(CL)}


def _online(spans, q, k8, v8, pad, kscale, Li):
    """A rank's online softmax over its spans, for every query head of the
    group (a warp each on the GPU): q (G, Dh) f32, k8/v8 (Li, Dh) int8
    values as f32; (m (G,), l (G,), o (G, Dh)) in f32, as the kernel:
    scores (q . k8) * kscale + mask bias, l and o rescaled by e^(m_old -
    m_new) a span."""
    G, Dh = q.shape
    m = torch.full((G,), -torch.inf)
    lsum = torch.zeros(G)
    o = torch.zeros(G, Dh)
    for z in spans:
        keys = slice(z * SPAN, min(Li, (z + 1) * SPAN))
        s = (q @ k8[keys].T) * kscale + torch.where(pad[keys], NEG_INF, 0.0)
        m_new = torch.maximum(m, s.max(dim=1).values)
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[:, None])
        lsum = lsum * alpha + p.sum(dim=1)
        o = o * alpha[:, None] + p @ v8[keys]
        m = m_new
    return m, lsum, o


def _combine(parts):
    """(m, l, o) parts added in order, each e^(m - M) weighted, per head;
    a part with m = -inf (no span) is skipped."""
    M = torch.stack([m for m, _, _ in parts]).max(dim=0).values
    lsum = torch.zeros_like(parts[0][1])
    o = torch.zeros_like(parts[0][2])
    for m, l_, o_ in parts:
        w = torch.where(m == -torch.inf, 0.0, torch.exp(m - M))
        lsum = lsum + w * l_
        o = o + w[:, None] * o_
    return M, lsum, o


def split_gqa_cross(q, ck, cv, ks, vs, pad, sm_scale, ranks):
    """The cross kernel's arithmetic and schedule: q (B, H, Dh) f32, ck/cv
    (B, Li, kvH, Dh) int8, ks/vs (B, kvH) f32, pad (B, Li) bool. Returns
    (out (B, H, Dh) f32, spans read {(b, c): [span, ...]})."""
    B, Li, kvH, Dh = ck.shape
    G = q.shape[1] // kvH
    out = torch.empty(B, kvH * G, Dh)
    read = {}
    for b in range(B):
        sched = span_schedule(pad[b].numpy(), ranks)
        CL = cluster_ranks(Li, ranks)
        for c in range(kvH):
            qg = q[b, c * G:(c + 1) * G]
            k8, v8 = ck[b, :, c].float(), cv[b, :, c].float()
            rank_parts = [_online(sched[r], qg, k8, v8, pad[b],
                                  ks[b, c] * sm_scale, Li)
                          for r in range(CL)]
            _, lsum, o = _combine(rank_parts)
            out[b, c * G:(c + 1) * G] = o / lsum[:, None] * vs[b, c]
            read[(b, c)] = sorted(z for s in sched.values() for z in s)
    return out, read


def plain_gqa_cross(q, ck, cv, ks, vs, pad, sm_scale):
    """The plain version's cross-attention (greedy_decode_reference, f32):
    dequantized K/V, grouped heads, scores * scale + mask bias, softmax,
    weights @ V."""
    B, Li, kvH, Dh = ck.shape
    G = q.shape[1] // kvH
    k = (ck.float() * ks[:, None, :, None]).repeat_interleave(G, dim=2)
    v = (cv.float() * vs[:, None, :, None]).repeat_interleave(G, dim=2)
    s = torch.einsum("bhd,blhd->bhl", q, k) * sm_scale
    s = s + torch.where(pad, NEG_INF, 0.0)[:, None, :]
    return torch.einsum("bhl,blhd->bhd", torch.softmax(s, dim=-1), v)


def _pad_mask(pattern, B, Li, seed):
    """(B, Li) bool, True = pad: `ragged` padded tails of random lengths
    (one of 1, one full), `all_real`, `one_real` (a single real key, the
    first), `hole` (real keys with a masked stretch of two spans and a
    masked key between them), `no_real` (every key padded)."""
    rng = np.random.default_rng(seed)
    pad = np.ones((B, Li), bool)
    if pattern == "ragged":
        lengths = rng.integers(1, Li + 1, B)
        lengths[0], lengths[-1] = 1, Li
        for b, n in enumerate(lengths):
            pad[b, :n] = False
    elif pattern == "all_real":
        pad[:] = False
    elif pattern == "one_real":
        pad[:, 0] = False
    elif pattern == "hole":
        pad[:, :Li * 7 // 8] = False
        pad[:, SPAN:3 * SPAN] = True
        pad[:, 3 * SPAN + 5] = True
    return torch.from_numpy(pad)


def _gqa_inputs(pattern, B=3, Li=600, kvH=2, G=4, Dh=32, seed=0):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, kvH * G, Dh))
                         .astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, B, Li, kvH, Dh))
                         .astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((1, B, Li, kvH, Dh))
                         .astype(np.float32))
    ck, ks = quantize_rows(k, (2, 4))
    cv, vs = quantize_rows(v, (2, 4))
    return (q, ck[0], cv[0], ks[0].reshape(B, kvH), vs[0].reshape(B, kvH),
            _pad_mask(pattern, B, Li, seed))


PATTERNS = ["ragged", "all_real", "one_real", "hole", "no_real"]


@pytest.mark.parametrize("ranks", [1, 2, 3, 4])
@pytest.mark.parametrize("pattern", PATTERNS)
def test_gqa_cross_schedule_reads_each_real_key_once(pattern, ranks):
    _, _, _, _, _, pad = _gqa_inputs(pattern)
    B, Li = pad.shape
    nsp = -(-Li // SPAN)
    for b in range(B):
        spans = [z for s in span_schedule(pad[b].numpy(), ranks).values()
                 for z in s]
        assert len(spans) == len(set(spans))  # no span read twice
        real = ~pad[b]
        has_real = [bool(real[z * SPAN:(z + 1) * SPAN].any())
                    for z in range(nsp)]
        if real.any():
            # every real key in exactly one span read; none read without
            assert sorted(spans) == [z for z in range(nsp) if has_real[z]]
        else:  # no real key: the full average over every key
            assert sorted(spans) == list(range(nsp))
    if pattern == "hole":
        assert all(z not in (1, 2) for s in span_schedule(
            pad[0].numpy(), ranks).values() for z in s)


@pytest.mark.parametrize("ranks", [1, 2, 3, 4])
@pytest.mark.parametrize("pattern", PATTERNS)
def test_gqa_cross_schedule_matches_plain(pattern, ranks):
    q, ck, cv, ks, vs, pad = _gqa_inputs(pattern, seed=ranks)
    sm = 1.0 / math.sqrt(q.shape[-1])
    got, _ = split_gqa_cross(q, ck, cv, ks, vs, pad, sm, ranks)
    ref = plain_gqa_cross(q, ck, cv, ks, vs, pad, sm)
    scale = float(ref.abs().max())
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                               atol=TOL * scale)


@pytest.mark.parametrize("pattern", ["ragged", "hole", "no_real"])
def test_gqa_cross_schedule_matches_pallas(pattern):
    """Each (row, query head) as a row of the Pallas cross_attn_decode
    (interpret mode), over its kv head's int8 K/V and scales."""
    q, ck, cv, ks, vs, pad = _gqa_inputs(pattern, seed=7)
    B, Li, kvH, Dh = ck.shape
    G = q.shape[1] // kvH
    sm = 1.0 / math.sqrt(Dh)
    got, _ = split_gqa_cross(q, ck, cv, ks, vs, pad, sm, ranks=4)
    rows = lambda a: np.repeat(a, G, axis=1).reshape(  # noqa: E731
        B * kvH * G, *a.shape[2:])
    k_rows = rows(ck.permute(0, 2, 3, 1).numpy())   # (BH, Dh, Li)
    v_rows = rows(cv.permute(0, 2, 1, 3).numpy())   # (BH, Li, Dh)
    bias = np.where(pad.numpy(), NEG_INF, 0.0).astype(np.float32)
    bias = np.repeat(bias, kvH * G, axis=0)
    pallas = np.asarray(jax_cross_attn_decode(
        jnp.asarray(q.reshape(B * kvH * G, Dh).numpy()),
        jnp.asarray(k_rows), jnp.asarray(v_rows), jnp.asarray(bias),
        jnp.asarray(rows(ks.numpy()[..., None]).reshape(-1, 1)),
        jnp.asarray(rows(vs.numpy()[..., None]).reshape(-1, 1)),
        sm_scale=sm, interpret=True)).reshape(B, kvH * G, Dh)
    scale = float(np.abs(pallas).max())
    np.testing.assert_allclose(got.numpy(), pallas, rtol=0, atol=TOL * scale)


# ------------------------------------------------------------- _prepare
def _tiny(kv=1):
    cfg = tiny_config()
    cfg = dataclasses.replace(
        cfg, MODEL=dataclasses.replace(cfg.MODEL, NUM_KV_HEAD=kv))
    params = init_params(jax.random.PRNGKey(0), JaxDims.from_config(cfg))
    return params_from_jax(jax.tree.map(np.asarray, params)), \
        ModelDims.from_config(cfg)


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_prepare_holds_only_what_the_kernels_read(cd):
    params, dims = _tiny()
    B, Li = 3, 20
    rng = np.random.default_rng(0)
    memory = torch.from_numpy(rng.standard_normal(
        (B, Li, dims.num_model)).astype(np.float32))
    mask = torch.from_numpy(rng.random((B, Li)) < 0.3)
    ts, ints = PD._prepare(params, memory, mask, dims, cd, early_exit=True)
    # every pointer of DecodeArgs, and nothing else: the split-K
    # workspace, the cross-attention parts and their counters are gone
    assert set(ts) == set(PD._PTR_FIELDS)
    for gone in ("gemm_ws", "gemm_counters", "attn_ws", "attn_counters"):
        assert gone not in ts
    assert set(ints) == set(PD._INT_FIELDS)
    args = PD.DecodeArgs(**ints, **{n: 0 for n in PD._PTR_FIELDS})
    # bf16 products on the tensor cores unless asked for the SIMT order
    assert args.simt_order == 0 and args.is_bf16 == (cd == torch.bfloat16)
    # the head's columns padded to the cluster GEMM's tile, the pad zero
    NH = dims.vocab_size + dims.num_model + 1
    assert ts["head_w"].shape == (dims.num_model, -(-NH // 32) * 32)
    assert not ts["head_w"][:, NH:].any()
    # the state at step 0: zero input, counters and flags
    for n in ("x", "done", "halt", "num_steps", "counter", "output"):
        assert not ts[n].any(), n
    assert (ts["attach"] == -1).all()
    assert ts["q"].dtype == ts["k_cache"].dtype == cd


def test_cuda_dims_check_takes_the_flagship_and_refuses_the_rest():
    _, dims = _tiny()
    flagship = dataclasses.replace(dims, num_model=512, num_head=8,
                                   num_kv_head=2, num_feedforward=1024)
    assert flagship.head_dim == 64 and flagship.kv_groups == 4
    PD._check_cuda_dims(flagship)
    with pytest.raises(ValueError, match="CUDA decode"):
        PD._check_cuda_dims(dims)  # tiny: D=16, Dh=8
