"""The redesigned CUDA decode loop (`csrc/decode.cu`, `csrc/decode_step.cu`,
`ops/persistent_decode.py`), checked on the CPU where the kernels cannot
run:

- the ctypes mirror `DecodeArgs` against `struct DecodeArgs` parsed from
  the CUDA header, names, kinds and order, and that header the struct's
  one definition, included by both sources;
- the GQA cross-attention's schedule, emulated in plain PyTorch: spans of
  64 keys dealt round robin to the ranks of a cluster, a span with no real
  key skipped (any mask), each kept span read once for every query head of
  the group, one online softmax per head over a rank's spans, the ranks'
  (m, l, o) combined in rank order; held against the plain version's
  cross-attention and the Pallas kernel in interpret mode;
- `_prepare`: the state and scratch the kernels read, without the split-K
  workspaces and counters of the earlier design; the packed weights and
  structure mask kept between calls, every other tensor the call's own;
- the caches a decode shape and a params object keep between calls
  (`LaunchStates`, `PreparedWeights`): what each is keyed on, what makes
  packed weights stale, the least recently used shape dropped past
  `GRAPH_SHAPES`, and a failed call that keeps nothing it built.

The CUDA kernels themselves run only on the GPU (`chip_smoke.py` decode,
serve and fit hold them against the plain version)."""
import copy
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
from plankassembly_tpu_torch.decode import precompute_cross_kv
from plankassembly_tpu_torch.ops import persistent_decode as PD
from plankassembly_tpu_torch.ops.cross_decode import quantize_rows
from tests.tiny import tiny_config

CSRC = os.path.join(os.path.dirname(PD.__file__), os.pardir, "csrc")
DECODE_COMMON = "decode_common.cuh"
SPAN = 64          # kSpan in csrc/decode_common.cuh
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


def _read(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def test_decode_args_mirror_matches_the_cuda_struct():
    want = _struct_fields(_read(DECODE_COMMON))
    got = [(n, "ptr" if t is ctypes.c_void_p else "int")
           for n, t in PD.DecodeArgs._fields_]
    assert got == want
    assert ctypes.sizeof(PD.DecodeArgs) == 8 * len(want)


@pytest.mark.parametrize("source", ["decode.cu", "decode_step.cu"])
def test_each_decode_source_takes_the_one_decode_args(source):
    """Both routes' sources are built apart and pass one DecodeArgs
    between them: each includes the header that defines it, and no other
    source under csrc/ defines its own (two copies that drift apart would
    disagree on the layout without an error)."""
    assert f'#include "{DECODE_COMMON}"' in _read(source)
    defines = [n for n in sorted(os.listdir(CSRC))
               if n.endswith((".cu", ".cuh"))
               and re.search(r"struct DecodeArgs \{", _read(n))]
    assert defines == [DECODE_COMMON]


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
def _tiny(kv=1, layers=1):
    cfg = tiny_config()
    cfg = dataclasses.replace(
        cfg, MODEL=dataclasses.replace(cfg.MODEL, NUM_KV_HEAD=kv,
                                       NUM_DECODER_LAYERS=layers))
    params = init_params(jax.random.PRNGKey(0), JaxDims.from_config(cfg))
    return params_from_jax(jax.tree.map(np.asarray, params)), \
        ModelDims.from_config(cfg)


# a step plan that runs in one wave: 13 clusters of 5 rows, all held
ONE_WAVE = {"rows": 5, "cluster": 8, "clusters": 13, "held": 13}


@pytest.mark.parametrize("cd,route", [
    (torch.float32, "chain"), (torch.bfloat16, "step"),
    (torch.bfloat16, "chain")], ids=["f32", "bf16", "bf16-chain"])
def test_prepare_holds_only_what_the_kernels_read(cd, route):
    params, dims = _tiny(layers=2)
    B, Li = 3, 20
    rng = np.random.default_rng(0)
    memory = torch.from_numpy(rng.standard_normal(
        (B, Li, dims.num_model)).astype(np.float32))
    mask = torch.from_numpy(rng.random((B, Li)) < 0.3)
    ts, ints = PD._prepare(params, memory, mask, dims, cd, early_exit=True,
                           route=route)
    step = route == "step"
    # every pointer of DecodeArgs the route reads, and nothing else: the
    # split-K workspace, the cross-attention parts and their counters are
    # gone, and the step keeps the chain's scratch in shared memory
    want = set(PD._PTR_FIELDS) - (set(PD._CHAIN_SCRATCH) if step else set())
    assert set(ts) == want
    for gone in ("gemm_ws", "gemm_counters", "attn_ws", "attn_counters"):
        assert gone not in ts
    assert set(ints) == set(PD._INT_FIELDS)
    # the kernels read each tensor from its pointer, row-major
    for n, t in ts.items():
        assert t.is_contiguous(), n
    # the cross K/V of the kept projections: those of the params, bit for
    # bit
    L, kvH = dims.num_decoder_layers, dims.kv_heads
    for i, (n, s) in enumerate((("ck", "ck_scale"), ("cv", "cv_scale"))):
        q, scale = quantize_rows(precompute_cross_kv(params, memory, dims,
                                                     cd)[i], (2, 4))
        assert torch.equal(ts[n], q.reshape(L, B, Li, -1))
        assert torch.equal(ts[s], scale.reshape(L, B, kvH))
    args = PD.DecodeArgs(**ints, **{n: 0 for n in PD._PTR_FIELDS})
    # the route's flag and the compute dtype
    assert args.step == step and args.is_bf16 == (cd == torch.bfloat16)
    # the head's columns padded (to the chain's GEMM tile, or to whole
    # strips of 4 for the step), the pad zero
    NH = dims.vocab_size + dims.num_model + 1
    if step:
        assert ts["head_w"].shape == (-(-NH // 4), dims.num_model, 4)
        flat = ts["head_w"].permute(1, 0, 2).reshape(dims.num_model, -1)
    else:
        assert ts["head_w"].shape == (dims.num_model, -(-NH // 32) * 32)
        flat = ts["head_w"]
    assert not flat[:, NH:].any()
    # the state at step 0: zero input (the chain's), counters and flags
    for n in ("x", "done", "halt", "num_steps", "counter", "output"):
        assert n not in ts or not ts[n].any(), n
    assert (ts["attach"] == -1).all()
    assert ts["k_cache"].dtype == cd
    assert step or ts["q"].dtype == cd
    # the packed weights and the structure mask are kept: a second call
    # reads the same tensors; the rest is the call's own
    again, _ = PD._prepare(params, memory, mask, dims, cd, early_exit=True,
                           route=route)
    kept = set(PD._WEIGHT_FIELDS) | {"struct_mask"}
    assert kept <= set(ts)
    for n in set(ts):
        assert (again[n] is ts[n]) == (n in kept), n


@pytest.mark.parametrize("cd,route", [
    (torch.bfloat16, "step"), (torch.float32, "chain")])
def test_route_bf16_takes_the_step_f32_the_chain(cd, route):
    assert PD.route_of(cd, ONE_WAVE) == route
    params, dims = _tiny()
    memory = torch.zeros(2, 5, dims.num_model)
    mask = torch.zeros(2, 5, dtype=torch.bool)
    _, ints = PD._prepare(params, memory, mask, dims, cd, early_exit=False,
                          route=route)
    assert ints["step"] == (route == "step")


@pytest.mark.parametrize("clusters,held,route", [
    (1, 13, "step"), (5, 13, "step"), (13, 13, "step"), (14, 13, "chain"),
    (52, 13, "chain"), (1, 1, "step"), (2, 1, "chain"), (None, 13, "chain")])
def test_bf16_takes_the_step_only_in_one_wave(clusters, held, route):
    """The step's plan chooses bf16's route: the step where the card holds
    every cluster at once, the chain on the tensor cores past one wave or
    where the step has no plan (None); f32 always the chain."""
    plan = None if clusters is None else dict(ONE_WAVE, clusters=clusters,
                                              held=held)
    assert PD.route_of(torch.bfloat16, plan) == route
    assert PD.route_of(torch.float32, plan) == "chain"


def test_prepare_off_cuda_takes_the_chain_without_a_plan(monkeypatch):
    """On a CPU tensor `_prepare` asks the library for no plan: the
    chain's layout."""
    def no_library(*args):
        raise AssertionError("step_plan called off CUDA")
    monkeypatch.setattr(PD, "step_plan", no_library)
    params, dims = _tiny()
    memory = torch.zeros(2, 5, dims.num_model)
    mask = torch.zeros(2, 5, dtype=torch.bool)
    ts, ints = PD._prepare(params, memory, mask, dims, torch.bfloat16,
                           early_exit=False)
    assert ints["step"] == 0 and "x" in ts


@pytest.mark.parametrize("name,width", [("wqkv", 8), ("wo", 8), ("w1", 8),
                                        ("w2", 8), ("head_w", 4)])
def test_step_weights_are_strips_of_the_products(name, width):
    """Strip s of the step's layout, row k, holds columns [width s, width
    (s + 1)) of row k of the product's weights (x @ W), as the chain's
    row-major copy has them."""
    params, dims = _tiny()
    memory = torch.zeros(2, 5, dims.num_model)
    mask = torch.zeros(2, 5, dtype=torch.bool)
    chain, _ = PD._prepare(params, memory, mask, dims, torch.float32, True)
    step, ints = PD._prepare(params, memory, mask, dims, torch.bfloat16,
                             True, route="step")
    assert ints["step"] == 1
    got = step[name].float()
    row_major = got.transpose(-3, -2).reshape(*got.shape[:-3],
                                              got.shape[-2], -1)
    want = chain[name].to(torch.bfloat16).float() if name != "head_w" \
        else chain[name]
    n = min(row_major.shape[-1], want.shape[-1])
    assert torch.equal(row_major[..., :n], want[..., :n])
    assert got.shape[-1] == width and got.is_contiguous()


def test_cuda_dims_check_takes_the_flagship_and_refuses_the_rest():
    _, dims = _tiny()
    flagship = dataclasses.replace(dims, num_model=512, num_head=8,
                                   num_kv_head=2, num_feedforward=1024)
    assert flagship.head_dim == 64 and flagship.kv_groups == 4
    PD._check_cuda_dims(flagship)
    with pytest.raises(ValueError, match="CUDA decode"):
        PD._check_cuda_dims(dims)  # tiny: D=16, Dh=8


def test_quantize_rows_gives_contiguous_rows_of_any_layout():
    """The einsum's cross K/V come out permuted: the int8 values and
    scales are contiguous all the same, and equal those of a contiguous
    copy of the input."""
    x = torch.randn(3, 2, 5, 2, 4).to(torch.bfloat16).permute(0, 2, 1, 3, 4)
    assert not x.is_contiguous()
    q, scale = quantize_rows(x, (2, 4))
    assert q.is_contiguous() and scale.is_contiguous()
    q0, scale0 = quantize_rows(x.contiguous(), (2, 4))
    assert torch.equal(q, q0) and torch.equal(scale, scale0)
    xf = x.float()  # the formula, on the input as it is
    s = torch.clamp(xf.abs().amax(dim=(2, 4), keepdim=True) / 127.0,
                    min=1e-8)
    assert torch.equal(q, torch.round(xf / s).to(torch.int8))


# --------------------------------------------------------------- the caches
@pytest.fixture
def fresh_weights(monkeypatch):
    """An empty weights cache of its own in `_prepare`'s place."""
    counts = {"hits": 0, "misses": 0}
    cache = PD.PreparedWeights(PD.WEIGHT_SETS, counts)
    monkeypatch.setattr(PD, "_weights", cache)
    return cache


def _prepare_tiny(params, dims, cd=torch.bfloat16, route="step"):
    memory = torch.zeros(2, 5, dims.num_model)
    mask = torch.zeros(2, 5, dtype=torch.bool)
    return PD._prepare(params, memory, mask, dims, cd, early_exit=True,
                       route=route)[0]


def _sources(params):
    return [t for part in ("decoder", "heads", "embed")
            for t in PD._leaves(params[part])]


def test_packed_weights_hold_across_calls_and_follow_each_update(
        fresh_weights):
    """The same params: the same packed tensors. An in-place update of any
    source tensor (as an optimizer's step makes it), or one leaf replaced
    by another tensor: packed again, with the new values. One set per
    params object survives the updates."""
    params, dims = _tiny()
    first = _prepare_tiny(params, dims)
    assert _prepare_tiny(params, dims)["wqkv"] is first["wqkv"]
    assert fresh_weights.counts == {"hits": 1, "misses": 1}
    before = first
    for i, t in enumerate(_sources(params)):
        with torch.no_grad():
            t.add_(1.0 / (i + 2))
        now = _prepare_tiny(params, dims)
        assert now["wqkv"] is not before["wqkv"], i
        before = now
    assert fresh_weights.counts["misses"] == 1 + len(_sources(params))
    assert len(fresh_weights.keys()) == 1
    # the packed weights are those of the updated params
    want = PD._pack_weights(params, torch.device("cpu"), torch.bfloat16,
                            True)
    for n in PD._WEIGHT_FIELDS:
        assert torch.equal(before[n], want[n]), n
    # a leaf replaced by an equal tensor of its own is another source
    params["embed"]["value"] = params["embed"]["value"].clone()
    assert _prepare_tiny(params, dims)["wqkv"] is not before["wqkv"]
    assert len(fresh_weights.keys()) == 1


def test_packed_weights_are_kept_per_params_dtype_and_layout(fresh_weights):
    params, dims = _tiny()
    other = copy.deepcopy(params)  # equal values, another object
    step = _prepare_tiny(params, dims)
    chain = _prepare_tiny(params, dims, route="chain")
    f32 = _prepare_tiny(params, dims, cd=torch.float32, route="chain")
    theirs = _prepare_tiny(other, dims)
    assert len({id(t["wqkv"]) for t in (step, chain, f32, theirs)}) == 4
    assert len(fresh_weights.keys()) == 4
    assert torch.equal(theirs["wqkv"], step["wqkv"])
    # every set stays while its params live, each call a hit
    for got, (p, cd, route) in zip(
            (step, chain, f32, theirs),
            [(params, torch.bfloat16, "step"), (params, torch.bfloat16,
                                                "chain"),
             (params, torch.float32, "chain"), (other, torch.bfloat16,
                                                "step")]):
        assert _prepare_tiny(p, dims, cd, route)["wqkv"] is got["wqkv"]
    assert fresh_weights.counts == {"hits": 4, "misses": 4}


def test_packed_weights_of_params_gone_are_dropped_first(fresh_weights):
    """Past `WEIGHT_SETS`, the sets whose params are gone leave before the
    least recently used live one."""
    params, dims = _tiny()
    _prepare_tiny(params, dims)
    for _ in range(PD.WEIGHT_SETS + 2):  # params of a moment each
        _prepare_tiny(copy.deepcopy(params), dims)
    keys = fresh_weights.keys()
    assert len(keys) <= 2
    assert keys[0][0] == id(params)


@pytest.mark.parametrize("change", [
    dict(B=4), dict(Li=48), dict(step=False), dict(cd=torch.float32),
    dict(early_exit=False)], ids=["B", "Li", "route", "dtype", "early_exit"])
def test_launch_key_separates_each_shape_and_setting(change):
    _, dims = _tiny()
    base = dict(B=3, Li=32, cd=torch.bfloat16, early_exit=True, step=True)
    key = PD._launch_key(torch.device("cuda:0"), PD._ints(
        base["B"], base["Li"], dims, base["cd"], base["early_exit"],
        base["step"]))
    same = PD._launch_key(torch.device("cuda:0"), PD._ints(
        base["B"], base["Li"], dims, base["cd"], base["early_exit"],
        base["step"]))
    other = dict(base, **change)
    moved = PD._launch_key(torch.device("cuda:0"), PD._ints(
        other["B"], other["Li"], dims, other["cd"], other["early_exit"],
        other["step"]))
    assert key == same and hash(key) == hash(same)
    assert moved != key
    assert PD._launch_key(torch.device("cuda:1"), PD._ints(
        base["B"], base["Li"], dims, base["cd"], base["early_exit"],
        base["step"])) != key


def test_launch_states_keep_the_16_most_recent_shapes():
    freed, counts = [], {"hits": 0, "misses": 0}
    cache = PD.LaunchStates(PD.GRAPH_SHAPES, freed.append, counts)
    assert PD.GRAPH_SHAPES == 16
    for k in range(16):
        assert cache.take(k) is None
        cache.give(k, f"state{k}")
    assert freed == [] and cache.keys() == list(range(16))
    # a call of shape 0 makes it the most recent: shape 1 goes first
    assert cache.take(0) == "state0"
    cache.give(0, "state0")
    assert cache.take(16) is None
    cache.give(16, "state16")
    assert freed == ["state1"]
    assert cache.keys() == list(range(2, 16)) + [0, 16]
    assert counts == {"hits": 1, "misses": 17}
    cache.clear()
    assert sorted(freed) == sorted(f"state{k}" for k in range(17))
    assert cache.keys() == []


def test_a_shape_taken_by_one_call_is_not_shared():
    """While a call holds its shape's state, another call of the shape
    builds its own; when both give theirs back one is kept, one freed."""
    freed, counts = [], {"hits": 0, "misses": 0}
    cache = PD.LaunchStates(PD.GRAPH_SHAPES, freed.append, counts)
    cache.give("shape", "a")
    assert cache.take("shape") == "a"
    assert cache.take("shape") is None
    cache.give("shape", "b")
    cache.give("shape", "a")
    assert freed == ["b"] and cache.keys() == ["shape"]
    assert cache.take("shape") == "a"


class FakeLibrary:
    """`plank_decode_*` of the CUDA library, on the host: states are ints,
    a run writes its stats (`cached` 1 for a state it saw before) or
    returns `fail` (a CUDA error)."""

    def __init__(self):
        self.made, self.freed, self.built = 0, [], set()
        self.fail = 0

    def plank_decode_state_new(self):
        self.made += 1
        return 1000 + self.made

    def plank_decode_state_free(self, state):
        self.freed.append(state)

    def plank_decode_run(self, args, steps, stream, state, stats):
        if self.fail:
            return self.fail
        stats[PD._STATS.index("cached")] = state in self.built
        self.built.add(state)
        return 0

    def plank_decode_replay_ns(self, state, ns):
        ns._obj.value = 1234
        return 0


def test_launch_keeps_a_state_only_once_its_call_succeeded(monkeypatch):
    counts = {"hits": 0, "misses": 0}
    lib = FakeLibrary()
    cache = PD.LaunchStates(PD.GRAPH_SHAPES, lib.plank_decode_state_free,
                            counts)
    monkeypatch.setattr(PD, "_launch_states", cache)
    steps = torch.tensor([7], dtype=torch.int32)
    args = PD.DecodeArgs()
    cache.give("other", 1)
    # a first call that fails: nothing kept, what it built freed
    lib.fail = 700
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        PD._launch(lib, args, "shape", 0, steps)
    assert cache.keys() == ["other"] and lib.freed == [1001]
    # a first call that succeeds builds a state and keeps it
    lib.fail = 0
    st, n, ns = PD._launch(lib, args, "shape", 0, steps)
    assert (st["cached"], n, ns) == (0, 7, 1234)
    assert cache.keys() == ["other", "shape"]
    # the next call of the shape runs on it
    st, _, _ = PD._launch(lib, args, "shape", 0, steps)
    assert st["cached"] == 1 and lib.made == 2
    assert counts == {"hits": 1, "misses": 2}
    # a later call that fails drops the shape's state, and only it
    lib.fail = 719
    with pytest.raises(RuntimeError, match="CUDA error 719"):
        PD._launch(lib, args, "shape", 0, steps)
    assert cache.keys() == ["other"] and lib.freed == [1001, 1002]
