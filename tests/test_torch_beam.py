"""The port's beam search (`plankassembly_tpu_torch/beam.py`) against the
JAX package's (`plankassembly_tpu/beam.py`) on the tiny config in float32,
and the trainer's decode options (`train/loop.py::Trainer._decode_batch`).
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plankassembly_tpu.beam import beam_decode as jax_beam_decode
from plankassembly_tpu.decode import quantize_decoder_weights as jax_qdw
from plankassembly_tpu_torch import decode as pd
from plankassembly_tpu_torch.beam import _topk_first_index, beam_decode
from plankassembly_tpu_torch.config import ModelDims
from tests.test_torch_decode import END_CASES, _port, _setup
from tests.test_torch_decode_options import _grid_params, _jax

# beam_scores: sums of up to 24 float32 log-probs (|score| ~ 100, where
# one ulp is 7.6e-6) from another log/softmax implementation
SCORE_TOL = 1e-5


def _crop_at_end(row, end):
    hits = np.flatnonzero(row == end)
    return row[: hits[0] + 1] if hits.size else row


def _assert_beams_equal(got, ref):
    for key in ("samples", "attach", "beam_samples", "beam_attach"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)
    assert got["num_steps"] == int(ref["num_steps"])
    np.testing.assert_allclose(got["beam_scores"].numpy(),
                               np.asarray(ref["beam_scores"]),
                               rtol=SCORE_TOL, atol=SCORE_TOL)


@pytest.mark.parametrize("num_beams", [1, 2, 4])
@pytest.mark.parametrize("end", ["none", "staggered"])
@pytest.mark.parametrize("kv", [0, 1], ids=["mha", "gqa"])
def test_beam_decode_f32_matches_jax(kv, end, num_beams):
    """Every hypothesis, its pointers and num_steps identical; scores
    within SCORE_TOL (relative)."""
    seed, bias = END_CASES[end][kv]
    cfg, jdims, params, batch = _setup(kv, bias, seed=seed)
    jp, jb = _jax(params, batch)
    ref = jax_beam_decode(jp, jb, jdims, num_beams=num_beams,
                          compute_dtype=jnp.float32)
    tp, tb = _port(params, batch)
    got = beam_decode(tp, tb, ModelDims.from_config(cfg),
                      num_beams=num_beams, compute_dtype=torch.float32)
    _assert_beams_equal(got, ref)


@pytest.mark.parametrize("early_exit", [True, False], ids=["exit", "full"])
def test_beam_alpha_bucket_and_full_bound_match_jax(early_exit):
    """Length normalization (alpha 0.6), a kv bucket that crops, and the
    full S-step bound."""
    seed, bias = END_CASES["staggered"][1]
    cfg, jdims, params, batch = _setup(1, bias, seed=seed)
    jp, jb = _jax(params, batch)
    kw = dict(num_beams=3, alpha=0.6, kv_bucket=28, early_exit=early_exit)
    ref = jax_beam_decode(jp, jb, jdims, compute_dtype=jnp.float32, **kw)
    tp, tb = _port(params, batch)
    got = beam_decode(tp, tb, ModelDims.from_config(cfg),
                      compute_dtype=torch.float32, **kw)
    _assert_beams_equal(got, ref)
    if not early_exit:
        assert got["num_steps"] == cfg.DATA.MAX_OUTPUT_LENGTH


@pytest.mark.parametrize("kv", [0, 1], ids=["mha", "gqa"])
def test_beam_tie_heavy_input_matches_jax(kv):
    """Heads whose logits take three values make most candidates tie
    exactly; the top K must take the lower flat index first, as
    jax.lax.top_k does."""
    cfg, jdims, params, batch = _setup(kv, 0.0, seed=1)
    rng = np.random.default_rng(7)
    for h in ("vocab", "pointer", "switch"):
        params["heads"][h]["w"] = np.zeros_like(params["heads"][h]["w"])
        params["heads"][h]["b"] = np.zeros_like(params["heads"][h]["b"])
    vb = params["heads"]["vocab"]["b"]
    vb[:] = rng.integers(0, 3, vb.shape) * 0.5
    jp, jb = _jax(params, batch)
    tp, tb = _port(params, batch)
    for k in (2, 4):
        ref = jax_beam_decode(jp, jb, jdims, num_beams=k,
                              compute_dtype=jnp.float32)
        got = beam_decode(tp, tb, ModelDims.from_config(cfg), num_beams=k,
                          compute_dtype=torch.float32)
        _assert_beams_equal(got, ref)
        # the case is what it names: the hypotheses tie exactly
        scores = got["beam_scores"].numpy()
        assert (scores == scores[:, :1]).all(), scores


def test_topk_breaks_ties_to_the_lower_index():
    x = torch.tensor([[0.0, 1.0, 1.0, -2.0, 1.0, 0.0]])
    values, idx = _topk_first_index(x, 4)
    ref_v, ref_i = jax.lax.top_k(jnp.asarray(x.numpy()), 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(values.numpy(), np.asarray(ref_v))
    assert idx.tolist() == [[1, 2, 4, 0]]


@pytest.mark.parametrize("kv", [0, 1], ids=["mha", "gqa"])
def test_beam1_matches_greedy(kv):
    """num_beams=1 reproduces the port's greedy decode ("xla", full
    precision) up to each row's END (JAX `test_beam1_matches_greedy`)."""
    seed, bias = END_CASES["staggered"][kv]
    cfg, jdims, params, batch = _setup(kv, bias, seed=seed)
    tp, tb = _port(params, batch)
    dims = ModelDims.from_config(cfg)
    g = pd.greedy_decode(tp, tb, dims, compute_dtype=torch.float32,
                         cross_impl="xla")
    b = beam_decode(tp, tb, dims, num_beams=1, compute_dtype=torch.float32)
    gs, bs = g["samples"].numpy(), b["samples"].numpy()
    ga, ba = g["attach"].numpy(), b["attach"].numpy()
    for i in range(gs.shape[0]):
        gc = _crop_at_end(gs[i], dims.end)
        np.testing.assert_array_equal(gc, bs[i, : len(gc)])
        np.testing.assert_array_equal(ga[i, : len(gc)], ba[i, : len(gc)])


def test_wider_beam_never_scores_worse():
    cfg, jdims, params, batch = _setup(1, 0.0, seed=0)
    tp, tb = _port(params, batch)
    dims = ModelDims.from_config(cfg)
    s1 = beam_decode(tp, tb, dims, num_beams=1,
                     compute_dtype=torch.float32)["beam_scores"].numpy()
    s4 = beam_decode(tp, tb, dims, num_beams=4,
                     compute_dtype=torch.float32)["beam_scores"].numpy()
    assert (s4.max(axis=1) >= s1.max(axis=1) - 1e-4).all(), (s1, s4)


def test_beam_weight_quant():
    """Grid weights: the int8 decode equals the unquantized one exactly;
    natural weights: the port's int8 beams equal JAX's, quantized in the
    loop or ahead of it (`quantize_decoder_weights`)."""
    cfg, jdims, params, batch = _setup(1, 0.0, seed=0)
    dims = ModelDims.from_config(cfg)
    gp, gb = _port(_grid_params(
        jax.tree.map(np.copy, params)), batch)
    plain = beam_decode(gp, gb, dims, num_beams=2, compute_dtype=torch.float32)
    quant = beam_decode(gp, gb, dims, num_beams=2, compute_dtype=torch.float32,
                        weight_quant=True)
    for key in ("beam_samples", "beam_attach", "beam_scores"):
        np.testing.assert_array_equal(plain[key].numpy(), quant[key].numpy())

    jp, jb = _jax(params, batch)
    tp, tb = _port(params, batch)
    ref = jax_beam_decode(jp, jb, jdims, num_beams=2,
                          compute_dtype=jnp.float32, weight_quant=True)
    _assert_beams_equal(beam_decode(tp, tb, dims, num_beams=2,
                                    compute_dtype=torch.float32,
                                    weight_quant=True), ref)
    ref = jax_beam_decode(jax_qdw(jp), jb, jdims, num_beams=2,
                          compute_dtype=jnp.float32)
    _assert_beams_equal(beam_decode(pd.quantize_decoder_weights(tp), tb,
                                    dims, num_beams=2,
                                    compute_dtype=torch.float32), ref)


# ------------------------------------------------------------- the trainer
@pytest.mark.parametrize("impl,kv_quant", [("beam2", False), ("auto", False),
                                           ("xla", False), ("mxu", False),
                                           ("auto", True), ("mxu", True)])
def test_trainer_decode_impls(impl, kv_quant, tmp_path):
    """trainer.decode_impl routes the eval decode as in JAX: "beam<K>"
    through beam_decode, the others through greedy_decode with
    `kv_quant or None`; each row equals the direct call."""
    from plankassembly_tpu_torch.train.loop import Trainer
    from tests.test_torch_train_e2e import _port_cfg
    from tests.tiny import random_batch, tiny_config

    seed, bias = END_CASES["staggered"][1]
    _, _, params, _ = _setup(1, bias, seed=seed)
    jcfg = tiny_config()
    jcfg = dataclasses.replace(
        jcfg, MODEL=dataclasses.replace(jcfg.MODEL, NUM_KV_HEAD=1),
        trainer=dataclasses.replace(jcfg.trainer, decode_impl=impl,
                                    kv_quant=kv_quant,
                                    default_root_dir=str(tmp_path)))
    cfg = _port_cfg(jcfg)
    tr = Trainer(cfg, log_dir=str(tmp_path), compute_dtype=torch.float32,
                 device="cpu")
    tp, _ = _port(params, {})
    batch = random_batch(jcfg, batch_size=4, seed=seed)
    arrays, out = tr._decode_batch(types.SimpleNamespace(params=tp), batch)
    tr.close()
    dims = ModelDims.from_config(cfg)
    inputs = {k: v for k, v in arrays.items() if k.startswith("input")}
    bucket = pd.pick_kv_bucket(batch["input_mask"])
    if impl.startswith("beam"):
        want = beam_decode(tp, inputs, dims, num_beams=2,
                           compute_dtype=torch.float32, kv_bucket=bucket)
        assert out["beam_scores"].shape == (4, 2)
    else:
        want = pd.greedy_decode(tp, inputs, dims, compute_dtype=torch.float32,
                                kv_bucket=bucket, cross_impl=impl,
                                kv_quant=kv_quant or None)
    np.testing.assert_array_equal(out["samples"].numpy(),
                                  want["samples"].numpy())
    np.testing.assert_array_equal(out["attach"].numpy(),
                                  want["attach"].numpy())
    assert out["samples"].shape == (4, dims.max_output_length)
