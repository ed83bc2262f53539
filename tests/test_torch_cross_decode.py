"""The port's cross-attention decode step (`plankassembly_tpu_torch/ops/
cross_decode.py`, plain version of `csrc/cross_decode.cu`) against the
Pallas kernel in interpret mode (`plankassembly_tpu/ops/cross_decode.py`).
The CUDA kernel itself runs only on the GPU (`chip_smoke.py` holds it
against this plain version)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plankassembly_tpu.ops.cross_decode import (
    cross_attn_decode as jax_cross_attn_decode,
    quantize_rows as jax_quantize_rows,
)
from plankassembly_tpu_torch.ops import cross_decode as CD

# f32 scores, softmax and weighted sums in another order: ~1e-7 of the
# output's scale, far inside 1e-5
TOL = 1e-5


def _inputs(kv, BH=6, Dh=16, Li=40, seed=0):
    """q, K (JAX layout (BH, Dh, Li)), V (BH, Li, Dh), bias with masked
    tails, and per-row scales, from a numpy seed."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((BH, Dh)).astype(np.float32)
    k = rng.standard_normal((BH, Dh, Li)).astype(np.float32)
    v = rng.standard_normal((BH, Li, Dh)).astype(np.float32)
    lengths = rng.integers(1, Li + 1, BH)
    lengths[0] = Li
    bias = np.where(np.arange(Li)[None] < lengths[:, None], 0.0,
                    -1e9).astype(np.float32)
    if kv == "int8":
        kq, ks = jax_quantize_rows(jnp.asarray(k), axes=(1, 2))
        vq, vs = jax_quantize_rows(jnp.asarray(v), axes=(1, 2))
        return (q, np.asarray(kq), np.asarray(vq), bias,
                np.asarray(ks).reshape(BH, 1), np.asarray(vs).reshape(BH, 1))
    dt = jnp.bfloat16 if kv == "bf16" else jnp.float32
    q, k, v = (np.asarray(jnp.asarray(a, dt).astype(jnp.float32))
               for a in (q, k, v))
    return q, k, v, bias, None, None


def _port(q, k, v, bias, ks, vs, kv):
    """The same inputs for the port: K turned key-major, (BH, Li, Dh)."""
    dt = {"int8": torch.float32, "bf16": torch.bfloat16,
          "f32": torch.float32}[kv]
    kvdt = torch.int8 if kv == "int8" else dt
    as_t = (lambda a, d: None if a is None else torch.from_numpy(
        np.array(a)).to(d))
    return (as_t(q, dt), as_t(np.swapaxes(k, 1, 2), kvdt), as_t(v, kvdt),
            as_t(bias, torch.float32), as_t(ks, torch.float32),
            as_t(vs, torch.float32))


@pytest.mark.parametrize("kv", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("shape", [(6, 16, 40), (20, 8, 128)],
                         ids=["small", "two_blocks"])
def test_reference_matches_pallas_interpret(kv, shape):
    BH, Dh, Li = shape
    q, k, v, bias, ks, vs = _inputs(kv, BH, Dh, Li, seed=BH + Li)
    jq = jnp.asarray(q, jnp.bfloat16 if kv == "bf16" else jnp.float32)
    jk = jnp.asarray(k) if kv == "int8" else jnp.asarray(k, jq.dtype)
    jv = jnp.asarray(v) if kv == "int8" else jnp.asarray(v, jq.dtype)
    sm = 1.0 / np.sqrt(Dh)
    ref = jax_cross_attn_decode(
        jq, jk, jv, jnp.asarray(bias),
        None if ks is None else jnp.asarray(ks),
        None if vs is None else jnp.asarray(vs), sm_scale=sm, interpret=True)
    got = CD.cross_attn_decode_reference(*_port(q, k, v, bias, ks, vs, kv),
                                         sm_scale=sm)
    assert got.dtype == torch.float32 and got.shape == (BH, Dh)
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=TOL * scale)


def test_quantize_rows_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 40, 2, 8)).astype(np.float32) * 5
    x[0, 1] = 0.0  # an all-zero row takes the 1e-8 floor
    for dims in ((2, 4), (2, 3), (4,)):
        q, s = CD.quantize_rows(torch.from_numpy(x), dims)
        jq, js = jax_quantize_rows(jnp.asarray(x), axes=dims)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        assert q.dtype == torch.int8 and s.dtype == torch.float32


def test_cpu_wrapper_is_the_reference_and_counts_nothing():
    args = _port(*_inputs("int8"), "int8")
    before = CD.launches
    got = CD.cross_attn_decode(*args, sm_scale=0.25)
    want = CD.cross_attn_decode_reference(*args, sm_scale=0.25)
    assert CD.launches == before
    assert torch.equal(got, want)
    q, k, v, bias, ks, vs = args
    with pytest.raises(ValueError, match="bias"):
        CD.cross_attn_decode(q, k, v, bias[:, :5], ks, vs, sm_scale=0.25)
    with pytest.raises(ValueError, match="k/v shape"):
        CD.cross_attn_decode(q, k[:, :, :4], v, bias, ks, vs, sm_scale=0.25)
    with pytest.raises(ValueError, match="one scale per row"):
        CD.cross_attn_decode(q, k, v, bias, ks[:2], vs, sm_scale=0.25)
