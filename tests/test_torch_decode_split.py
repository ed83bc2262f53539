"""The schedules of the MHA decode kernels on the GPU, emulated in plain
PyTorch on the CPU and held against the port's plain versions and the
Pallas kernels in interpret mode:

- `csrc/cross_decode.cu` (cross_attn_decode): keys split into spans dealt
  round robin to the ranks of a cluster (2 on the GPU) and then to a
  rank's warps, a span with no real key skipped when its row has one, an
  online softmax over each warp's spans, the warps' and then the ranks'
  (m, l, o) combined in order;
- the cross kernel of `csrc/fused_decode.cu` (fused_decoder_layer): chunks
  of CH keys with no real key skipped when the row has one, the rest spread
  round robin over the ranks of a cluster, every chunk's (l, o) added in
  chunk order by rank 0.

The rows have 0 real keys, 1, a mid extent, every key, a masked key inside
their extent and a masked span or chunk between real ones. The CUDA kernels
themselves run only on the GPU (`chip_smoke.py` mha_kernels holds them
against the plain versions on such rows)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plankassembly_tpu.ops.cross_decode import (
    cross_attn_decode as jax_cross_attn_decode,
    quantize_rows as jax_quantize_rows,
)
from plankassembly_tpu.ops.fused_decode import (
    fused_decoder_layer as jax_layer,
)
from plankassembly_tpu_torch.ops import cross_decode as CD
from plankassembly_tpu_torch.ops import fused_decode as FD
from tests.test_torch_fused_decode import (
    _inputs as layer_inputs, _torch, jax_to_port_layouts,
)

NEG_INF = -1e9
MASKED = NEG_INF / 2   # a key whose bias is at most this is masked
# the key split adds the same f32 terms in another order
TOL = 1e-6


def _real_rows(Li, B, seed, gap=(64, 128)):
    """(B, Li) bool, True on real keys: rows of 0 real keys, 1, a mid
    extent, every key, a masked key inside the extent, and the masked keys
    [gap[0], gap[1]) between real ones; random prefixes after."""
    rng = np.random.default_rng(seed)
    real = np.zeros((B, Li), bool)
    real[1, :1] = True
    real[2, :Li // 5] = True
    real[3] = True
    real[4, :Li // 2] = True
    real[4, Li // 4] = False
    real[5, :gap[0]] = True
    real[5, gap[1]:Li * 3 // 4] = True
    for b in range(6, B):
        real[b, :rng.integers(1, Li + 1)] = True
    return real


# ---------------------------------------------------------------- kernel 4
def _online(parts, k, v, q, bias, r, kscale, Dh):
    """Online softmax over a list of key slices of row r: (m, l, o) in f32,
    l and o rescaled by e^(m_old - m_new) at each slice."""
    m_run = torch.tensor(-torch.inf)
    l_run = torch.zeros(())
    o_run = torch.zeros(Dh)
    for keys in parts:
        s = (k[r, keys].float() @ q[r].float()) * kscale \
            + bias[r, keys].float()
        m_new = torch.maximum(m_run, s.max())
        alpha = torch.exp(m_run - m_new)
        p = torch.exp(s - m_new)
        l_run = l_run * alpha + p.sum()
        o_run = o_run * alpha + p @ v[r, keys].float()
        m_run = m_new
    return m_run, l_run, o_run


def _combine(parts, Dh):
    """(m, l, o) of several parts added in order, each e^(m - M) weighted."""
    M = max(m for m, _, _ in parts)
    o_sum = torch.zeros(Dh)
    l_sum = torch.zeros(())
    for m, l, o in parts:
        if m == -torch.inf:
            continue
        w = torch.exp(m - M)
        l_sum = l_sum + w * l
        o_sum = o_sum + w * o
    return M, l_sum, o_sum


def split_cross_attn_decode(q, k, v, bias, ks, vs, *, sm_scale, span,
                            ranks=2, warps=4):
    """csrc/cross_decode.cu's schedule: rank c of a row's min(ranks,
    nspan) takes the spans c, c + ranks, ... of `span` keys; a span with no
    real key is skipped when the row has one; warp w of a rank takes every
    `warps`-th of the spans the rank keeps and runs an online softmax over
    them (f32 running max m, sum l and o); the rank adds its warps' (m, l,
    o) in warp order and rank 0 the ranks' in rank order, each e^(m - M)
    weighted, then divides once. Returns (out, taken (BH, nspan) bool)."""
    BH, Li, Dh = k.shape
    nspan = -(-Li // span)
    CL = min(ranks, nspan)
    ks = torch.ones(BH) if ks is None else ks.reshape(BH).float()
    vs = torch.ones(BH) if vs is None else vs.reshape(BH).float()
    real = bias > MASKED
    taken = torch.zeros((BH, nspan), dtype=torch.bool)
    out = torch.empty((BH, Dh), dtype=torch.float32)
    for r in range(BH):
        rank_parts = []
        for c in range(CL):
            kept = []
            for z in range(c, nspan, CL):
                keys = slice(z * span, min(Li, (z + 1) * span))
                if real[r, keys].any() or not real[r].any():
                    taken[r, z] = True
                    kept.append(keys)
            warp_parts = [_online(kept[w::warps], k, v, q, bias, r,
                                  sm_scale * ks[r], Dh)
                          for w in range(warps)]
            rank_parts.append(_combine(warp_parts, Dh))
        _, den, num = _combine(rank_parts, Dh)
        out[r] = num / den * vs[r]
    return out, taken


def _cross_inputs(kv, BH=8, Dh=16, Li=200, seed=0):
    """Port-layout inputs (K (BH, Li, Dh)) and the Pallas kernel's (K (BH,
    Dh, Li)), from a numpy seed, with the rows of `_real_rows`."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((BH, Dh)).astype(np.float32)
    k = rng.standard_normal((BH, Li, Dh)).astype(np.float32)
    v = rng.standard_normal((BH, Li, Dh)).astype(np.float32)
    bias = np.where(_real_rows(Li, BH, seed), 0.0, NEG_INF).astype(np.float32)
    if kv == "int8":
        kq, ks = jax_quantize_rows(jnp.asarray(k), axes=(1, 2))
        vq, vs = jax_quantize_rows(jnp.asarray(v), axes=(1, 2))
        k, v = np.asarray(kq), np.asarray(vq)
        ks, vs = np.asarray(ks).reshape(BH, 1), np.asarray(vs).reshape(BH, 1)
        qdt, kvdt, jdt = torch.float32, torch.int8, jnp.float32
    else:
        ks = vs = None
        qdt, jdt = {"bf16": (torch.bfloat16, jnp.bfloat16),
                    "f32": (torch.float32, jnp.float32)}[kv]
        kvdt = qdt
        q, k, v = (np.asarray(jnp.asarray(a, jdt).astype(jnp.float32))
                   for a in (q, k, v))
    t = lambda a, d: None if a is None else torch.from_numpy(  # noqa: E731
        np.array(a)).to(d)
    port = (t(q, qdt), t(k, kvdt), t(v, kvdt), t(bias, torch.float32),
            t(ks, torch.float32), t(vs, torch.float32))
    jk = jnp.asarray(np.swapaxes(k, 1, 2))
    jv = jnp.asarray(v)
    if kv != "int8":
        jk, jv = jk.astype(jdt), jv.astype(jdt)
    jax_args = (jnp.asarray(q, jdt), jk, jv, jnp.asarray(bias),
                None if ks is None else jnp.asarray(ks),
                None if vs is None else jnp.asarray(vs))
    return port, jax_args


@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("span", [32, 64])
@pytest.mark.parametrize("kv", ["int8", "bf16", "f32"])
def test_key_split_matches_plain_and_pallas(kv, span, ranks):
    port, jax_args = _cross_inputs(kv, seed=span)
    sm = 0.25
    got, _ = split_cross_attn_decode(*port, sm_scale=sm, span=span,
                                     ranks=ranks)
    ref = CD.cross_attn_decode_reference(*port, sm_scale=sm)
    pallas = np.asarray(jax_cross_attn_decode(*jax_args, sm_scale=sm,
                                              interpret=True))
    scale = float(ref.abs().max())
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                               atol=TOL * scale)
    np.testing.assert_allclose(got.numpy(), pallas, rtol=0,
                               atol=TOL * scale)


@pytest.mark.parametrize("span", [32, 64])
def test_key_split_reads_only_spans_with_a_real_key(span):
    port, _ = _cross_inputs("int8", seed=span)
    Li = port[1].shape[1]
    nspan = -(-Li // span)
    _, taken = split_cross_attn_decode(*port, sm_scale=0.25, span=span)
    real = _real_rows(Li, 8, span)
    for r in range(8):
        want = [bool(real[r, z * span:(z + 1) * span].any())
                for z in range(nspan)]
        if not any(want):  # no real key: the whole row, as the plain version
            want = [True] * nspan
        assert taken[r].tolist() == want, r
    # the rows of extent 0 and 1 and the masked stretch of row 5
    assert taken[0].all() and taken[1].tolist() == [True] + [False] * (
        nspan - 1)
    assert not taken[5, 64 // span:128 // span].any()


# ---------------------------------------------------------------- kernel 5
def cluster_split(nch):
    """Ranks per (row, head) and chunks per rank of the fused cross kernel
    (csrc/fused_decode.cu `cross_split`)."""
    npr = -(-nch // 8)
    return -(-nch // npr), npr


def split_fused_cross(q2, ck, cv, cks, cvs, cbias, sm_scale, CL=None):
    """The fused cross kernel's schedule: chunk c of CH keys goes to rank
    c % CL; a chunk with no real key is skipped (its l and o left at 0)
    when the row has one; the row max is taken over the chunks taken; each
    rank computes its chunks' (l, o), and rank 0 adds every chunk's in
    chunk order. Returns (out (B, H, Dh) f32, taken (B, nch) bool)."""
    B, H, Li, Dh = ck.shape
    CH = FD.chunk_width(Li)
    nch = Li // CH
    CL = cluster_split(nch)[0] if CL is None else CL
    real = (cbias > MASKED).reshape(B, nch, CH).any(dim=-1)
    taken = real | ~real.any(dim=1, keepdim=True)
    sc = FD.cross_scores(q2, ck, cks, cbias, sm_scale)
    keys = taken.repeat_interleave(CH, dim=1)[:, None, :]
    m = torch.where(keys, sc, -torch.inf).amax(dim=-1, keepdim=True)
    out = torch.empty((B, H, Dh), dtype=torch.float32)
    for b in range(B):
        rows = slice(b, b + 1)
        part = {}  # chunk -> (l, o), filled by the rank that owns it
        for rank in range(CL):
            for c in range(rank, nch, CL):
                part[c] = (FD.cross_chunk(sc[rows], m[rows], cv[rows],
                                          c * CH, CH) if taken[b, c] else
                           (torch.zeros((1, H, 1)), torch.zeros((1, H, Dh))))
        lt = torch.zeros((1, H, 1))
        ot = torch.zeros((1, H, Dh))
        for c in range(nch):
            lt = lt + part[c][0]
            ot = ot + part[c][1]
        out[b] = (ot * (cvs[rows].float()[..., None] / lt))[0]
    return out, taken


def _fused_cross_inputs(pattern, B=6, H=2, Dh=16, Li=640, seed=0):
    rng = np.random.default_rng(seed)
    q2 = torch.from_numpy(rng.standard_normal((B, H, Dh)).astype(np.float32))
    mem = rng.standard_normal((B, Li, H, Dh)).astype(np.float32)
    ckq, cks = jax_quantize_rows(jnp.asarray(mem), axes=(1, 3))
    cvq, cvs = jax_quantize_rows(jnp.asarray(
        rng.standard_normal((B, Li, H, Dh)).astype(np.float32)), axes=(1, 3))
    ck = torch.from_numpy(np.array(ckq)).permute(0, 2, 1, 3).contiguous()
    cv = torch.from_numpy(np.array(cvq)).permute(0, 2, 3, 1).contiguous()
    real = {"ragged": _real_rows(Li, B, seed, gap=(128, 256)),
            "every_key": np.ones((B, Li), bool),
            "no_real_key": np.zeros((B, Li), bool)}[pattern]
    cbias = torch.from_numpy(np.where(real, 0.0, NEG_INF).astype(np.float32))
    return (q2, ck, cv, torch.from_numpy(np.array(cks)).reshape(B, H),
            torch.from_numpy(np.array(cvs)).reshape(B, H), cbias)


@pytest.mark.parametrize("pattern", ["ragged", "every_key", "no_real_key"])
def test_chunk_skipping_is_exact(pattern):
    """One rank (chunk order): skipping the chunks with no real key leaves
    the row max, every chunk's integer sums and the output bit for bit."""
    args = _fused_cross_inputs(pattern, seed=3)
    sm = 0.25
    got, taken = split_fused_cross(*args, sm, CL=1)
    ref = FD.cross_reference(*args, sm)
    assert torch.equal(got, ref)
    q2, ck, cv, cks, cvs, cbias = args
    sc = FD.cross_scores(q2, ck, cks, cbias, sm)
    m = sc.amax(dim=-1, keepdim=True)
    CH = FD.chunk_width(ck.shape[2])
    for b, c in zip(*torch.nonzero(~taken, as_tuple=True)):
        rows = slice(int(b), int(b) + 1)
        lc, oc = FD.cross_chunk(sc[rows], m[rows], cv[rows], int(c) * CH, CH)
        assert not lc.any() and not oc.any()  # exactly 0: nothing to add
    if pattern == "ragged":  # rows of 0 and 1 real keys, a masked chunk
        assert taken[0].all()
        assert taken[1].tolist() == [True, False, False, False, False]
        assert taken[5].tolist() == [True, False, True, True, False]
    else:
        assert taken.all()


@pytest.mark.parametrize("CL", [None, 1, 2, 3])
def test_cluster_split_matches_plain(CL):
    """Chunks over CL ranks, every chunk's (l, o) added in chunk order by
    rank 0: the plain version bit for bit, whatever the split."""
    args = _fused_cross_inputs("ragged", seed=4)
    got, _ = split_fused_cross(*args, 0.25, CL=CL)
    ref = FD.cross_reference(*args, 0.25)
    assert torch.equal(got, ref)


def test_cluster_split_of_the_serving_bucket():
    """Li = 1152 (nine chunks): five ranks of two chunks at most."""
    assert cluster_split(9) == (5, 2)
    assert cluster_split(8) == (8, 1)
    assert cluster_split(16) == (8, 2)
    assert cluster_split(1) == (1, 1)


@pytest.mark.parametrize("cd", ["f32", "bf16"])
def test_layer_with_split_cross_matches_pallas(cd, monkeypatch):
    """The whole layer with the split cross schedule in place of the
    plain one, on ragged rows, against the Pallas kernel in interpret
    mode."""
    B, H, Dh, S, Li, t = 6, 2, 16, 24, 640, 9
    x, weights, caches = layer_inputs(B, H, Dh, S, Li, seed=7)
    CH = FD.chunk_width(Li)
    cbias = np.where(_real_rows(Li, B, 7, gap=(128, 256)), 0.0,
                     NEG_INF).astype(np.float32)
    caches[8] = jnp.asarray(cbias.reshape(B, Li // CH, CH).transpose(1, 0, 2))
    jcd, tcd = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[cd]
    sm = 1.0 / np.sqrt(Dh)
    ref = jax_layer(x, t, *weights, *caches, H=H, Dh=Dh, sm_scale=sm, cd=jcd,
                    interpret=True, block_rows=2)
    port = jax_to_port_layouts(*caches, H, Dh)
    assert torch.equal(port[8], torch.from_numpy(cbias))
    monkeypatch.setattr(FD, "cross_reference",
                        lambda *a: split_fused_cross(*a)[0])
    got = FD.fused_decoder_layer_reference(
        _torch(x), t, *(_torch(a) for a in weights), *port, H=H, Dh=Dh,
        sm_scale=sm, cd=tcd)
    x_out, nk, nv, nks, nvs = (np.asarray(a) for a in ref)
    np.testing.assert_array_equal(got[1].numpy(), nk)
    np.testing.assert_array_equal(got[2].numpy(), nv)
    for name, a, b in (("x_out", got[0], x_out), ("nks", got[3], nks),
                       ("nvs", got[4], nvs)):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-5,
                                   err_msg=name)
