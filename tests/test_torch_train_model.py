"""The port's training loss, gradients and optimizer against the JAX
package, on the tiny config in float32 with dropout 0
(`plankassembly_tpu_torch/models/model.py::train_step_loss`,
`train/state.py`)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from plankassembly_tpu.models.model import (
    ModelDims as JaxDims, init_params as jax_init, train_step_loss as jax_loss,
)
from plankassembly_tpu.train.state import (
    init_state as jax_init_state, make_train_step as jax_make_step,
)
from plankassembly_tpu_torch.checkpoint import params_from_jax
from plankassembly_tpu_torch.config import ModelDims
from plankassembly_tpu_torch.models.model import (
    _dropout, init_params, train_step_loss,
)
from plankassembly_tpu_torch.train.state import (
    init_state, make_optimizer, make_train_step, tree_leaves,
)
from tests.tiny import random_batch, tiny_config

# the tolerances of tests/test_torch_parity.py: float32 on both sides, sums
# in another order; 3e-5 for the loss and gradients (a reduction over the
# batch and positions), 2e-5 relative on top for the larger gradients
LOSS_ATOL = 3e-5
GRAD_ATOL, GRAD_RTOL = 3e-5, 2e-5


def _cfg(kv, dropout=0.0):
    cfg = tiny_config()
    return dataclasses.replace(cfg, MODEL=dataclasses.replace(
        cfg.MODEL, NUM_KV_HEAD=kv, DROPOUT=dropout))


def _batch(cfg):
    batch = random_batch(cfg, batch_size=3, seed=11)
    # ragged input and program lengths (suffix pads, as packing gives)
    batch["input_mask"][1, 12:] = True
    batch["input_value"][1, 12:] = cfg.TOKEN.PAD
    batch["output_mask"][2, 7:] = True
    batch["output_value"][2, 7:] = cfg.TOKEN.PAD
    batch["output_label"][2, 7:] = cfg.TOKEN.PAD
    return batch


def _flat(tree):
    return {"/".join(p): t for p, t in tree_leaves(tree)}


def _jax_flat(tree):
    return {"/".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("kv", [0, 1], ids=["mha", "gqa"])
@pytest.mark.parametrize("flash", [True, False], ids=["kernel_path", "plain"])
def test_train_step_loss_and_grads_match_jax(kv, flash):
    """flash=True takes the fused training attention (on the CPU its plain
    version, kv heads indexed in place, rate 0); flash=False the einsum
    path with additive biases. JAX runs its XLA path."""
    cfg = _cfg(kv)
    jdims = JaxDims.from_config(cfg)
    params = jax_init(jax.random.PRNGKey(4), jdims)
    batch = _batch(cfg)

    def f(p):
        return jax_loss(p, {k: jnp.asarray(v) for k, v in batch.items()},
                        jdims, rng=jax.random.PRNGKey(0), deterministic=False,
                        compute_dtype=jnp.float32, flash=False)

    (ref_loss, ref_mets), ref_grads = jax.value_and_grad(f, has_aux=True)(
        params)

    ours = params_from_jax(jax.tree.map(np.asarray, params))
    for _, t in tree_leaves(ours):
        t.requires_grad_(True)
    loss, mets = train_step_loss(
        ours, {k: torch.from_numpy(v) for k, v in batch.items()},
        ModelDims.from_config(cfg), deterministic=False,
        compute_dtype=torch.float32, flash=flash)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), atol=LOSS_ATOL)
    assert float(mets["accuracy"]) == pytest.approx(
        float(ref_mets["accuracy"]), abs=1e-6)
    ref = _jax_flat(ref_grads)
    got = {k: t.grad.numpy() for k, t in _flat(ours).items()}
    assert sorted(got) == sorted(ref)
    for name in ref:
        np.testing.assert_allclose(got[name], ref[name], atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=name)


def test_training_dropout_runs_on_both_attention_paths():
    """With dropout on, the fused path and the plain path both train: a
    finite loss that moves with the generator, and gradients everywhere."""
    cfg = _cfg(1, dropout=0.2)
    dims = ModelDims.from_config(cfg)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    for flash in (True, False):
        losses = []
        for seed in (0, 1):
            params = init_params(torch.Generator().manual_seed(3), dims)
            for _, t in tree_leaves(params):
                t.requires_grad_(True)
            loss, _ = train_step_loss(
                params, batch, dims, rng=torch.Generator().manual_seed(seed),
                compute_dtype=torch.float32, flash=flash)
            loss.backward()
            assert torch.isfinite(loss)
            assert all(t.grad is not None and torch.isfinite(t.grad).all()
                       for _, t in tree_leaves(params))
            losses.append(float(loss))
        assert losses[0] != losses[1]


def test_dropout_mask_rate_and_scale():
    x = torch.ones(200_000)
    y = _dropout(torch.Generator().manual_seed(0), x, 0.2, False)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.8) < 0.005
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1.25))
    assert _dropout(None, x, 0.2, True) is x


def test_init_params_shapes_and_bounds_match_jax():
    cfg = _cfg(1)
    ref = _jax_flat(jax_init(jax.random.PRNGKey(0), JaxDims.from_config(cfg)))
    ours = {k: t.numpy() for k, t in _flat(init_params(
        torch.Generator().manual_seed(0), ModelDims.from_config(cfg))).items()}
    assert sorted(ours) == sorted(ref)
    for name, r in ref.items():
        a = ours[name]
        assert a.shape == r.shape and a.dtype == np.float32, name
        if np.all(r == 0) or np.all(r == 1):  # biases 0, norm scales 1
            np.testing.assert_array_equal(a, r)
        else:  # xavier-uniform: the same bound
            bound = np.sqrt(6.0 / (a.shape[-2] + a.shape[-1]))
            assert np.abs(a).max() <= bound and np.abs(r).max() <= bound
            assert np.abs(a).max() > 0.5 * bound


@pytest.mark.parametrize("steps", [1, 3])
def test_adam_update_matches_optax(steps):
    """The same gradients through torch.optim.Adam and optax.adam give the
    same parameters (float32; the two order the update's operations
    differently, a few ulp of an update of size ~lr)."""
    rng = np.random.default_rng(0)
    p0 = {"a": rng.standard_normal((5, 7)).astype(np.float32),
          "b": {"c": rng.standard_normal(11).astype(np.float32)}}
    grads = [{"a": rng.standard_normal((5, 7)).astype(np.float32) * s,
              "b": {"c": rng.standard_normal(11).astype(np.float32) * s}}
             for s in (1.0, 1e-3, 30.0)][:steps]
    opt = optax.adam(1e-3)
    jp, js = p0, opt.init(p0)
    for g in grads:
        upd, js = opt.update(g, js, jp)
        jp = optax.apply_updates(jp, upd)
    state = init_state(params_from_jax(p0), make_optimizer(1e-3))
    for g in grads:
        for (_, t), (_, gt) in zip(tree_leaves(state.params),
                                   tree_leaves(params_from_jax(g))):
            t.grad = gt
        state.optimizer.step()
    for name, r in _jax_flat(jp).items():
        np.testing.assert_allclose(_flat(state.params)[name].detach().numpy(),
                                   r, atol=1e-7, rtol=1e-6)


@pytest.mark.parametrize("steps", [1, 3])
def test_train_steps_match_jax(steps):
    """Whole training steps (loss, backward, Adam) against the JAX step:
    the parameters after 1 and 3 steps on the same batch, f32, dropout 0.
    Adam divides by the root of the squared gradient, so a gradient that
    differs in its last bits moves a parameter by that share of lr = 1e-3:
    2e-6 absolute is ~1000 ulp of the step's rounding and far below one
    step (~1e-3). The key biases `bk` are left out of that comparison: a
    constant added to every score of a row leaves the softmax unchanged,
    so their exact gradient is 0 and both frameworks hand Adam rounding
    noise (~1e-12), which it turns into steps of +-lr with the noise's
    sign; they are held to moving at most lr per step instead."""
    cfg = dataclasses.replace(_cfg(1), LR=1e-3)
    jdims = JaxDims.from_config(cfg)
    params = jax_init(jax.random.PRNGKey(5), jdims)
    batch = _batch(cfg)
    opt = optax.adam(cfg.LR)
    jstep = jax_make_step(opt, jdims, compute_dtype=jnp.float32,
                          donate=False)
    jstate = jax_init_state(params, opt)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    state = init_state(params_from_jax(jax.tree.map(np.asarray, params)),
                       make_optimizer(cfg.LR))
    step = make_train_step(ModelDims.from_config(cfg),
                           compute_dtype=torch.float32, flash=True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for _ in range(steps):
        jstate, jm = jstep(jstate, jb, jax.random.PRNGKey(1))
        mets = step(state, tb, torch.Generator().manual_seed(1))
        np.testing.assert_allclose(float(mets["loss"]), float(jm["loss"]),
                                   atol=LOSS_ATOL)
    assert state.step == int(jstate.step) == steps
    init = _jax_flat(params)
    for name, r in _jax_flat(jstate.params).items():
        got = _flat(state.params)[name].detach().numpy()
        if name.endswith("/bk"):
            for p in (got, r):
                assert np.abs(p - init[name]).max() <= steps * cfg.LR * 1.01
            continue
        np.testing.assert_allclose(got, r, atol=2e-6, err_msg=name)
