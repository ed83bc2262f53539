"""The port's encoder and fused-attention plain version against the JAX
package, on the tiny config in float32 (`plankassembly_tpu_torch/models/
model.py`, `ops/attention.py`)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plankassembly_tpu.models.model import (
    ModelDims as JaxDims, encode as jax_encode, init_params,
)
from plankassembly_tpu.ops.attention import (
    flash_attention as pallas_flash, xla_attention,
)
from plankassembly_tpu_torch.checkpoint import params_from_jax
from plankassembly_tpu_torch.config import ModelDims
from plankassembly_tpu_torch.models.model import encode
from plankassembly_tpu_torch.ops import attention as port_attn
from tests.tiny import random_batch, tiny_config

# float32 on both sides; the sums run in another order (XLA vs PyTorch's
# CPU kernels), which moves the last bits of values O(1): 1e-5 covers it
# with room, and a real semantic difference is orders of magnitude larger.
ATOL = RTOL = 1e-5


def _cfg(kv):
    cfg = tiny_config()
    return dataclasses.replace(
        cfg, MODEL=dataclasses.replace(cfg.MODEL, NUM_KV_HEAD=kv))


@pytest.mark.parametrize("flash", [True, False], ids=["lengths", "bias"])
@pytest.mark.parametrize("kv", [0, 1], ids=["mha", "gqa"])
def test_encode_f32_matches_jax(kv, flash):
    """flash=True takes the fused-attention path (kv lengths, kv heads
    indexed in place); flash=False the plain path (additive pad bias, K/V
    repeated over each group)."""
    cfg = _cfg(kv)
    jdims = JaxDims.from_config(cfg)
    params = init_params(jax.random.PRNGKey(3), jdims)
    batch = {k: v for k, v in random_batch(cfg, batch_size=3, seed=5).items()
             if k.startswith("input")}
    batch["input_mask"][1, 10:] = True  # a shorter row: ragged lengths
    batch["input_value"][1, 10:] = cfg.TOKEN.PAD
    ref = jax_encode(params, {k: jnp.asarray(v) for k, v in batch.items()},
                     jdims, compute_dtype=jnp.float32, flash=flash)
    ours = encode(params_from_jax(jax.tree.map(np.asarray, params)),
                  {k: torch.from_numpy(v) for k, v in batch.items()},
                  ModelDims.from_config(cfg), compute_dtype=torch.float32,
                  flash=flash)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                               atol=ATOL, rtol=RTOL)


def _qkv(B, H, Hkv, Lq, Lk, Dh, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Lq, Dh)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, Lk, Dh)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, Lk, Dh)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("groups", [1, 4], ids=["mha", "gqa4"])
def test_flash_reference_matches_xla_and_pallas(causal, groups):
    """Ragged lengths including a fully masked row (length 0, which must
    average V uniformly, not give NaN); GQA by kv-head indexing against
    the JAX functions on explicitly repeated K/V. Lk = 128 so the Pallas
    kernel's 128-padding adds no keys."""
    B, H, Lq, Lk, Dh = 4, 8, 96, 128, 64
    q, k, v = _qkv(B, H, H // groups, Lq, Lk, Dh, seed=groups + 2 * causal)
    lengths = np.array([128, 57, 1, 0], np.int32)
    ours = port_attn.flash_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lengths), causal=causal).numpy()
    kr = np.repeat(k, groups, axis=1)
    vr = np.repeat(v, groups, axis=1)
    args = (jnp.asarray(q), jnp.asarray(kr), jnp.asarray(vr),
            jnp.asarray(lengths))
    ref = np.asarray(xla_attention(*args, causal=causal))
    pallas = np.asarray(pallas_flash(*args, causal=causal, interpret=True))
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(ours, pallas, atol=ATOL, rtol=RTOL)
    # the fully masked row is the plain mean of V over all Lk keys
    np.testing.assert_allclose(
        ours[3], np.broadcast_to(vr[3].mean(axis=1, keepdims=True), ours[3].shape),
        atol=ATOL, rtol=RTOL)


def test_flash_attention_cpu_dispatches_to_reference_and_counts_nothing():
    q, k, v = _qkv(2, 4, 2, 16, 16, 64, seed=9)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    lens = torch.tensor([16, 5], dtype=torch.int32)
    before = port_attn.launches
    got = port_attn.flash_attention(*t, lens)
    assert port_attn.launches == before
    torch.testing.assert_close(
        got, port_attn.flash_attention_reference(*t, lens), atol=0, rtol=0)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        port_attn.flash_attention(t[0], t[1][:, :1].repeat(1, 3, 1, 1),
                                  t[2][:, :1].repeat(1, 3, 1, 1), lens)
