"""The port's training attention (`plankassembly_tpu_torch/ops/flash_train.py`)
against the JAX package's Pallas `fused_attention_train`, run in interpret
mode on the CPU: forward and gradients, with and without dropout, causal
or not, MHA and GQA, a row with no real key and a query length above the
TPU plan's 512-row block; and the dropout mask bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plankassembly_tpu.ops.flash_train import (
    _cell_seed, _dropout_mask, _plan, fused_attention_train as jax_fused,
)
from plankassembly_tpu_torch.ops import flash_train as FT

# float32 on both sides; the softmax and the products sum in another order
# (XLA vs PyTorch's CPU kernels), which moves the last bits of O(1) values.
# 2e-5 covers that with room; one keep bit of the mask that differed moves
# an output by a weight of order 1/Lk (>= 1e-3 here), far above it.
ATOL = RTOL = 2e-5


def _inputs(B, H, Hkv, Lq, Lk, Dh, seed, lengths=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Lq, Dh)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, Lk, Dh)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, Lk, Dh)).astype(np.float32)
    do = rng.standard_normal((B, H, Lq, Dh)).astype(np.float32)
    if lengths is None:
        lengths = rng.integers(1, Lk + 1, (B,))
    return q, k, v, do, np.asarray(lengths, np.int32)


def _jax(q, k, v, do, lengths, seed, rate, causal):
    """The Pallas kernel in interpret mode, with K/V repeated over each
    group as the JAX model does before calling it; gradients through the
    repeat."""
    G = q.shape[1] // k.shape[1]

    def f(q, k, v):
        kr, vr = jnp.repeat(k, G, axis=1), jnp.repeat(v, G, axis=1)
        return jax_fused(q, kr, vr, jnp.asarray(lengths), jnp.int32(seed),
                         rate, causal, None, 512, True)

    out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return (np.asarray(out), *(np.asarray(g) for g in vjp(jnp.asarray(do))))


def _port(q, k, v, do, lengths, seed, rate, causal):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = FT.fused_attention_train(qt, kt, vt, torch.from_numpy(lengths),
                                   torch.tensor([seed], dtype=torch.int32),
                                   rate, causal)
    out.backward(torch.from_numpy(do))
    return (out.detach().numpy(), qt.grad.numpy(), kt.grad.numpy(),
            vt.grad.numpy())


CASES = {
    # name: (B, H, Hkv, Lq, Lk, causal, lengths)
    "mha": (2, 2, 2, 40, 56, False, None),
    "gqa": (2, 4, 2, 40, 56, False, None),
    "mha_causal": (2, 2, 2, 48, 48, True, None),
    "gqa_causal": (2, 4, 1, 48, 48, True, None),
    "zero_length_row": (3, 2, 1, 24, 40, False, [0, 17, 40]),
    "zero_length_row_causal": (2, 2, 2, 24, 24, True, [0, 9]),
    "long_query_qi1": (1, 2, 1, 600, 130, False, [97]),
    "long_query_qi1_causal": (1, 2, 2, 530, 530, True, [530]),
}


@pytest.mark.parametrize("rate", [0.0, 0.2], ids=["rate0", "rate0.2"])
@pytest.mark.parametrize("case", list(CASES))
def test_forward_and_gradients_match_jax(case, rate):
    B, H, Hkv, Lq, Lk, causal, lengths = CASES[case]
    args = _inputs(B, H, Hkv, Lq, Lk, 8, seed=len(case), lengths=lengths)
    seed = 123457
    ref = _jax(*args, seed, rate, causal)
    ours = _port(*args, seed, rate, causal)
    for name, a, b in zip(("o", "dq", "dk", "dv"), ours, ref):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL,
                                   err_msg=f"{case} rate={rate}: {name}")


def test_dropout_changes_output_and_seed_matters():
    """The mask is live: rate 0.2 differs from rate 0, and two seeds give
    two masks (so the equalities above are not vacuous)."""
    args = _inputs(1, 2, 2, 32, 32, 8, seed=0, lengths=[32])
    o0 = _port(*args, 5, 0.0, False)[0]
    o1 = _port(*args, 5, 0.2, False)[0]
    o2 = _port(*args, 6, 0.2, False)[0]
    assert np.abs(o0 - o1).max() > 1e-2
    assert np.abs(o1 - o2).max() > 1e-2


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 2, 2**31 - 1, -5],
                         ids=lambda s: f"seed{s}")
@pytest.mark.parametrize("rate", [0.1, 0.2, 0.5])
def test_dropout_keep_mask_bit_equal(seed, rate):
    """`dropout_keep_mask` is the Pallas kernel's `_dropout_mask` at the
    cell seed `_cell_seed` gives, including cells whose seed wraps past
    2^31 - 1 in int32."""
    for b, h, qi in ((0, 0, 0), (63, 7, 2), (5, 3, 1)):
        ref_cell = _cell_seed(jnp.asarray([seed], jnp.int32), b, h, qi)
        ref = np.asarray(_dropout_mask((128, 256), rate, ref_cell))
        cell = FT.cell_seed(seed, b, h, qi)
        ours = FT.dropout_keep_mask(128, 256, rate, cell).numpy()
        np.testing.assert_array_equal(ours, ref)
        assert 0.0 < 1.0 - ours.mean() < 1.0


def test_keep_mask_uses_the_tpu_plan_rows():
    """Row i of a call lies in the plan's cell i // block_q at local row
    i % block_q, with h the query head."""
    B, H, Lq, cols, seed, rate = 2, 3, 600, 256, 2**31 - 100, 0.2
    full = FT.keep_mask(B, H, Lq, cols, rate, seed).numpy()
    block_q = FT.plan(Lq, cols)[0]
    assert block_q == 512
    for b in range(B):
        for h in range(H):
            for qi in range(2):
                cell = _cell_seed(jnp.asarray([seed], jnp.int32), b, h, qi)
                ref = np.asarray(_dropout_mask((block_q, cols), rate, cell))
                rows = slice(qi * block_q, min(Lq, (qi + 1) * block_q))
                np.testing.assert_array_equal(
                    full[b, h, rows], ref[: rows.stop - rows.start])


@pytest.mark.parametrize("Lq,Lk", [(1, 1), (127, 127), (127, 1199),
                                   (1199, 1199), (512, 513), (513, 40)])
def test_plan_matches_jax(Lq, Lk):
    q = np.zeros((1, 1, Lq, 8), np.float32)
    k = np.zeros((1, 1, Lk, 8), np.float32)
    _, _, _, _, _, block_q, Lqp, Lkp = _plan(q, k, 512)
    assert FT.plan(Lq, Lk) == (block_q, Lqp, Lkp)


def test_cuda_path_is_the_kernel_or_raises():
    """On a non-CPU tensor the wrapper takes the kernel path: here, with no
    CUDA build, it raises rather than falling back to the plain version."""
    q = torch.zeros((1, 1, 4, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        FT.fused_attention_train(q, q, q, torch.ones(1, dtype=torch.int32),
                                 0, 0.2)
