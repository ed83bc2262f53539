"""The port's fused decoder layer (`plankassembly_tpu_torch/ops/
fused_decode.py`, plain versions of `csrc/fused_decode.cu`) against the
Pallas kernels in interpret mode (`plankassembly_tpu/ops/fused_decode.py`),
on the inputs of `tests/test_fused_decode.py::
test_fused_layer_against_int8_oracle` and variations of them. The CUDA
kernels themselves run only on the GPU (`chip_smoke.py` holds them against
these plain versions)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plankassembly_tpu.ops.cross_decode import quantize_rows
from plankassembly_tpu.ops.fused_decode import (
    fused_decoder_layer as jax_layer, fused_ffn as jax_ffn,
)
from plankassembly_tpu_torch.ops import fused_decode as FD

# float work in another order than XLA's; every integer sum is exact
TOL = 1e-5


def jax_to_port_layouts(kt_cache, v_cache, ks_cache, vs_cache, ck, cv, cks,
                        cvs, cbias, H, Dh):
    """The TPU kernel's cache and cross K/V layouts -> the port's
    (`ops/fused_decode.py`): kt (B, D, S) -> K (B, H, S, Dh); V (B, S, D)
    -> (B, H, Dh, S); chunked cross K (B, NCH, D, CH) -> (B, H, Li, Dh);
    chunked cross V (B, NCH, CH, D) -> (B, H, Dh, Li); cbias (NCH, B, CH)
    -> (B, Li). Scales keep their layout."""
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    B, D, S = kt_cache.shape
    NCH, CH = ck.shape[1], ck.shape[3]
    Li = NCH * CH
    k = t(kt_cache).reshape(B, H, Dh, S).permute(0, 1, 3, 2)
    v = t(v_cache).reshape(B, S, H, Dh).permute(0, 2, 3, 1)
    ck_p = (t(ck).permute(0, 2, 1, 3).reshape(B, H, Dh, Li)
            .permute(0, 1, 3, 2))
    cv_p = t(cv).reshape(B, Li, H, Dh).permute(0, 2, 3, 1)
    cbias_p = t(cbias).permute(1, 0, 2).reshape(B, Li)
    return (k.contiguous(), v.contiguous(), t(ks_cache), t(vs_cache),
            ck_p.contiguous(), cv_p.contiguous(), t(cks), t(cvs), cbias_p)


def _inputs(B=4, H=2, Dh=8, S=16, Li=32, seed=0, masked=False):
    """Weights, x, prior int8 caches and int8 cross K/V as
    `tests/test_fused_decode.py:65-116` builds them (JAX layouts)."""
    rng = np.random.default_rng(seed)
    D = H * Dh
    f32 = jnp.float32

    def w(*shape, s=0.2):
        return jnp.asarray(rng.standard_normal(shape) * s, f32)

    x = jnp.asarray(rng.standard_normal((B, D)), f32)
    weights = [w(D, 3 * D), w(3 * D, s=0.1), w(D, D), w(D, s=0.1),
               w(D, D), w(D, s=0.1), w(D, D), w(D, s=0.1),
               w(D, 2 * D), w(2 * D, s=0.1), w(2 * D, D), w(D, s=0.1),
               jnp.asarray(rng.standard_normal((6, D)) * 0.3 + 1.0, f32)]
    k_prior = rng.standard_normal((B, S, H, Dh)).astype(np.float32)
    v_prior = rng.standard_normal((B, S, H, Dh)).astype(np.float32)
    kq, ks = quantize_rows(jnp.asarray(k_prior), axes=(3,))
    vq, vs = quantize_rows(jnp.asarray(v_prior), axes=(3,))
    CH = min(128, Li)
    NCH = Li // CH
    mem = rng.standard_normal((B, Li, H, Dh)).astype(np.float32)
    ckq, cks = quantize_rows(jnp.asarray(mem), axes=(1, 3))
    cv_src = rng.standard_normal((B, Li, H, Dh)).astype(np.float32)
    cvq, cvs = quantize_rows(jnp.asarray(cv_src), axes=(1, 3))
    bias = np.zeros((B, Li), np.float32)
    if masked:  # padded keys at each row's end, one row with none
        lengths = rng.integers(1, Li + 1, B)
        lengths[0] = Li
        bias[np.arange(Li)[None] >= lengths[:, None]] = -1e9
    caches = [
        kq.reshape(B, S, D).transpose(0, 2, 1),              # (B, D, S)
        vq.reshape(B, S, D),
        ks.reshape(B, S, H).transpose(0, 2, 1),              # (B, H, S)
        vs.reshape(B, S, H).transpose(0, 2, 1),
        (ckq.reshape(B, Li, D).transpose(0, 2, 1)
         .reshape(B, D, NCH, CH).transpose(0, 2, 1, 3)),      # (B,NCH,D,CH)
        cvq.reshape(B, NCH, CH, D),
        cks.reshape(B, H), cvs.reshape(B, H),
        jnp.asarray(bias.reshape(B, NCH, CH).transpose(1, 0, 2)),
    ]
    return x, weights, caches


def _torch(a):
    return torch.from_numpy(np.array(a))


CASES = {  # (B, H, Dh, S, Li, t, masked)
    "oracle": (4, 2, 8, 16, 32, 5, False),
    "first_step": (4, 2, 8, 16, 32, 0, False),
    "last_step": (4, 2, 8, 16, 32, 15, False),
    "two_chunks_masked": (2, 2, 8, 24, 256, 9, True),
}


@pytest.mark.parametrize("cd", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_layer_reference_matches_pallas_interpret(case, cd):
    B, H, Dh, S, Li, t, masked = CASES[case]
    x, weights, caches = _inputs(B, H, Dh, S, Li, seed=len(case), masked=masked)
    jcd, tcd = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[cd]
    sm = 1.0 / np.sqrt(Dh)
    ref = jax_layer(x, t, *weights, *caches, H=H, Dh=Dh, sm_scale=sm, cd=jcd,
                    interpret=True, block_rows=2)
    port = jax_to_port_layouts(*caches, H, Dh)
    got = FD.fused_decoder_layer_reference(
        _torch(x), t, *(_torch(a) for a in weights), *port, H=H, Dh=Dh,
        sm_scale=sm, cd=tcd)
    x_out, nk, nv, nks, nvs = (np.asarray(a) for a in ref)
    np.testing.assert_array_equal(got[1].numpy(), nk)
    np.testing.assert_array_equal(got[2].numpy(), nv)
    for name, a, b in (("x_out", got[0], x_out), ("nks", got[3], nks),
                       ("nvs", got[4], nvs)):
        assert a.dtype == torch.float32, name
        np.testing.assert_allclose(a.numpy(), b, rtol=TOL, atol=TOL,
                                   err_msg=name)


def test_layout_helper_round_trips_the_oracle_indexing():
    """The converted caches hold the same values at the same (row, head,
    position, dim) as the JAX layouts."""
    B, H, Dh, S, Li = 2, 2, 8, 24, 256
    _, _, caches = _inputs(B, H, Dh, S, Li, seed=1)
    k, v, _, _, ck, cv, _, _, cbias = jax_to_port_layouts(*caches, H, Dh)
    kt, vj, ckj, cvj, cbj = (np.asarray(caches[i]) for i in (0, 1, 4, 5, 8))
    CH = ckj.shape[3]
    rng = np.random.default_rng(0)
    for _ in range(50):
        b, h, s, d = (int(rng.integers(n)) for n in (B, H, S, Dh))
        j = int(rng.integers(Li))
        assert k[b, h, s, d] == kt[b, h * Dh + d, s]
        assert v[b, h, d, s] == vj[b, s, h * Dh + d]
        assert ck[b, h, j, d] == ckj[b, j // CH, h * Dh + d, j % CH]
        assert cv[b, h, d, j] == cvj[b, j // CH, j % CH, h * Dh + d]
        assert cbias[b, j] == cbj[j // CH, b, j % CH]


@pytest.mark.parametrize("cd", ["f32", "bf16"])
def test_ffn_reference_matches_pallas_interpret(cd):
    x, weights, _ = _inputs(seed=5)
    w1, b1, w2, b2, ln = weights[8:]
    jcd, tcd = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[cd]
    ref = jax_ffn(x, w1, b1, w2, b2, ln[4:6], cd=jcd, interpret=True)
    got = FD.fused_ffn_reference(*(_torch(a) for a in (x, w1, b1, w2, b2)),
                                 _torch(ln)[4:6], cd=tcd)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


def test_cpu_wrappers_are_the_references_and_count_nothing():
    B, H, Dh, S, Li, t, _ = CASES["oracle"]
    x, weights, caches = _inputs(seed=2)
    port = jax_to_port_layouts(*caches, H, Dh)
    args = (_torch(x), t, *(_torch(a) for a in weights), *port)
    before = (FD.layer_launches, FD.ffn_launches)
    got = FD.fused_decoder_layer(*args, H=H, Dh=Dh, sm_scale=0.3,
                                 cd=torch.float32)
    want = FD.fused_decoder_layer_reference(*args, H=H, Dh=Dh, sm_scale=0.3,
                                            cd=torch.float32)
    assert (FD.layer_launches, FD.ffn_launches) == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    bad = list(args)
    bad[16] = port[1][:, :, :, :8]  # v_cache of the wrong length
    with pytest.raises(ValueError, match="v_cache"):
        FD.fused_decoder_layer(*bad, H=H, Dh=Dh, sm_scale=0.3)
    with pytest.raises(ValueError, match="outside"):
        FD.fused_decoder_layer(args[0], S, *args[2:], H=H, Dh=Dh,
                               sm_scale=0.3)
