"""The port's decode options against the JAX package on the tiny config
(`plankassembly_tpu_torch/decode.py`): the "auto" path and the defaults,
int8 decoder weights (`weight_quant`, `quantize_decoder_weights`),
`gqa_self_impl`, the no-cache decode and `eval_step`."""
import dataclasses
import itertools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plankassembly_tpu import decode as jd
from plankassembly_tpu.models.model import ModelDims as JaxDims
from plankassembly_tpu_torch import decode as pd
from plankassembly_tpu_torch.checkpoint import params_from_jax
from plankassembly_tpu_torch.config import ModelDims
from tests.test_torch_decode import END_CASES, _port, _setup
from tests.tiny import random_batch, tiny_config

SCALE = 2.0 ** -9  # a power of two: int8 dequantization is exact

# (kv layout, init seed) where the int8 cross K/V of the old default path
# ("persistent" semantics) moves tokens against the full-precision path
DEFAULT_CASES = [(0, 0), (1, 5)]


def _jax(params, batch):
    return (jax.tree.map(jnp.asarray, params),
            {k: jnp.asarray(v) for k, v in batch.items()})


def _assert_same(got, ref, steps=True):
    np.testing.assert_array_equal(got["samples"].numpy(),
                                  np.asarray(ref["samples"]))
    np.testing.assert_array_equal(got["attach"].numpy(),
                                  np.asarray(ref["attach"]))
    if steps:
        assert got["num_steps"] == int(ref["num_steps"])


def _grid(rng, shape):
    """Weights on an int8 grid with the column absmax at level 127, so the
    quantizer's scale is exactly SCALE (`tests/test_weight_quant.py`)."""
    q = rng.integers(-127, 128, shape)
    q[0] = np.where(rng.integers(0, 2, shape[1:]) > 0, 127, -127)
    return (q * SCALE).astype(np.float32)


def _grid_params(params, seed=3):
    rng = np.random.default_rng(seed)
    dec = params["decoder"]
    for blk, keys in (("self_attn", ("wq", "wk", "wv", "wo")),
                      ("cross_attn", ("wq", "wo")), ("ffn", ("w1", "w2"))):
        for k in keys:
            w = dec[blk][k]
            dec[blk][k] = np.repeat(_grid(rng, w.shape[1:])[None],
                                    w.shape[0], axis=0)
    for h in ("vocab", "pointer"):
        params["heads"][h]["w"] = _grid(rng, params["heads"][h]["w"].shape)
    return params


# ---------------------------------------------------------------- "auto"
@pytest.mark.parametrize("kv,seed", DEFAULT_CASES, ids=["mha", "gqa"])
def test_default_decode_computes_what_jax_default_computes(kv, seed):
    """With every option at its default, the port's greedy_decode resolves
    "auto" to "xla" on the CPU with full-precision K/V, as JAX's default
    does, and returns JAX's samples, attach and num_steps. (These seeds
    are ones where the int8 cross K/V of "persistent", the port's former
    default, moves tokens.)"""
    cfg, jdims, params, batch = _setup(kv, 0.0, seed=seed)
    dims = ModelDims.from_config(cfg)
    jp, jb = _jax(params, batch)
    ref = jd.greedy_decode(jp, jb, jdims, compute_dtype=jnp.float32)
    tp, tb = _port(params, batch)
    _assert_same(pd.greedy_decode(tp, tb, dims, compute_dtype=torch.float32),
                 ref)
    memory = pd.encode(tp, tb, dims, compute_dtype=torch.float32)
    _assert_same(pd.decode_from_memory(tp, memory, tb["input_mask"], dims,
                                       compute_dtype=torch.float32), ref)
    assert pd._pick_auto_impl("cpu", dims, 4, kv_quant=False,
                              self_quant=False, weight_quant=False,
                              prequantized=False) == "xla"
    old = pd.greedy_decode(tp, tb, dims, compute_dtype=torch.float32,
                           cross_impl="persistent")
    assert not np.array_equal(old["samples"].numpy(),
                              np.asarray(ref["samples"]))


def _flags():
    for kv_quant, self_quant, weight_quant, pre in itertools.product(
            (False, True), repeat=4):
        yield dict(kv_quant=kv_quant, self_quant=self_quant,
                   weight_quant=weight_quant, prequantized=pre)


@pytest.mark.parametrize("kv", [0, 2], ids=["mha", "gqa"])
def test_pick_auto_impl_table_matches_jax(kv):
    """Off CUDA the port picks what JAX picks off the TPU; on CUDA it picks
    what JAX picks on the TPU wherever the batch lies outside both bands
    (the TPU's 256 <= B <= 512, B % 8 == 0, and PERSISTENT_BATCHES), and
    "persistent" inside its band exactly when JAX's conditions hold."""
    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, MODEL=dataclasses.replace(
        cfg.MODEL, NUM_HEAD=4, NUM_KV_HEAD=kv))
    dims, jdims = ModelDims.from_config(cfg), JaxDims.from_config(cfg)
    lo, hi = pd.PERSISTENT_BATCHES
    batches = sorted({1, 7, 8, 64, 255, 256, 264, 500, 512, 513, 1024,
                      lo, hi, lo - 1, hi + 1} - {0})
    n_outside = 0
    for b, f in itertools.product(batches, _flags()):
        assert pd._pick_auto_impl("cpu", dims, b, **f) == \
            jd._pick_auto_impl("cpu", jdims, b, **f)
        got = pd._pick_auto_impl("cuda", dims, b, **f)
        in_tpu = 256 <= b <= 512 and b % 8 == 0
        if not lo <= b <= hi and not in_tpu:
            assert got == jd._pick_auto_impl("tpu", jdims, b, **f)
            n_outside += 1
        ok = (f["kv_quant"] and kv == 2 and not f["self_quant"]
              and not f["weight_quant"] and not f["prequantized"])
        assert got == ("persistent" if ok and lo <= b <= hi else "mxu")
    assert n_outside > 0


# ----------------------------------------------------------- weight_quant
def test_quantize_decoder_weights_matches_jax():
    cfg, jdims, params, _ = _setup(1, 0.0, seed=2)
    ref = jax.tree.map(np.asarray, jd.quantize_decoder_weights(
        jax.tree.map(jnp.asarray, params)))
    got = pd.quantize_decoder_weights(params_from_jax(params))
    n = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref):
        node = got
        for key in path:
            node = node[key.key]
        if leaf.dtype == np.int8:
            assert node.dtype == torch.int8
            np.testing.assert_array_equal(node.numpy(), leaf)
            n += 1
        elif path[-1].key == "s":
            np.testing.assert_allclose(node.numpy(), leaf, rtol=0, atol=1e-7)
    assert n == 10  # q, k, v, o, cross q, o, w1, w2, vocab, pointer


@pytest.mark.parametrize("impl", ["xla", "mxu"])
def test_weight_quant_grid_weights_bit_exact(impl):
    """On int8-grid weights with power-of-two scales the quantized decode
    equals the unquantized one exactly, in the port and in JAX, so every
    quantized product is wired (JAX `test_weight_quant.py`)."""
    cfg, jdims, params, batch = _setup(1, 0.0, seed=0)
    params = _grid_params(params)
    dims = ModelDims.from_config(cfg)
    tp, tb = _port(params, batch)
    kw = dict(compute_dtype=torch.float32, cross_impl=impl, kv_quant=False)
    plain = pd.greedy_decode(tp, tb, dims, **kw)
    quant = pd.greedy_decode(tp, tb, dims, weight_quant=True, **kw)
    _assert_same(quant, {k: np.asarray(v) if torch.is_tensor(v) else v
                         for k, v in plain.items()})
    jp, jb = _jax(params, batch)
    ref = jd.greedy_decode(jp, jb, jdims, compute_dtype=jnp.float32,
                           cross_impl=impl, kv_quant=False,
                           weight_quant=True)
    _assert_same(quant, ref)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["kv", "kv_int8"])
@pytest.mark.parametrize("impl", ["xla", "mxu"])
@pytest.mark.parametrize("kv", [0, 1], ids=["mha", "gqa"])
def test_weight_quant_f32_token_exact_vs_jax(kv, impl, kv_quant):
    """Natural weights, quantized in the loop on both sides: samples,
    attach and num_steps identical in float32."""
    seed, bias = END_CASES["staggered"][kv]
    cfg, jdims, params, batch = _setup(kv, bias, seed=seed)
    jp, jb = _jax(params, batch)
    ref = jd.greedy_decode(jp, jb, jdims, compute_dtype=jnp.float32,
                           cross_impl=impl, kv_quant=kv_quant,
                           weight_quant=True)
    tp, tb = _port(params, batch)
    got = pd.greedy_decode(tp, tb, ModelDims.from_config(cfg),
                           compute_dtype=torch.float32, cross_impl=impl,
                           kv_quant=kv_quant, weight_quant=True)
    _assert_same(got, ref)


@pytest.mark.parametrize("impl", ["xla", "mxu"])
def test_prequantized_weights_equal_in_loop_quantization(impl):
    """Weights from `quantize_decoder_weights` decode exactly as
    weight_quant=True does (natural weights: both quantize the same f32
    values, and per-column scales commute with concatenating q, k, v), and
    as JAX decodes JAX's own pre-quantized weights."""
    cfg, jdims, params, batch = _setup(1, END_CASES["staggered"][1][1],
                                       seed=END_CASES["staggered"][1][0])
    dims = ModelDims.from_config(cfg)
    tp, tb = _port(params, batch)
    kw = dict(compute_dtype=torch.float32, cross_impl=impl, kv_quant=True)
    live = pd.greedy_decode(tp, tb, dims, weight_quant=True, **kw)
    pre = pd.greedy_decode(pd.quantize_decoder_weights(tp), tb, dims, **kw)
    _assert_same(pre, {k: np.asarray(v) if torch.is_tensor(v) else v
                       for k, v in live.items()})
    jp, jb = _jax(params, batch)
    ref = jd.greedy_decode(jd.quantize_decoder_weights(jp), jb, jdims,
                           compute_dtype=jnp.float32, cross_impl=impl,
                           kv_quant=True)
    _assert_same(pre, ref)


@pytest.mark.parametrize("impl", ["persistent", "kernel", "fused"])
def test_weight_quant_warns_and_prequantized_raises_on_kernel_paths(impl):
    """As in JAX: the kernel paths ignore weight_quant with a warning and
    reject pre-quantized weights; "auto" takes mxu/xla for them."""
    cfg, jdims, params, batch = _setup(0, 1e4, seed=0)  # MHA, ends at t=0
    dims = ModelDims.from_config(cfg)
    tp, tb = _port(params, batch)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = pd.greedy_decode(tp, tb, dims, compute_dtype=torch.float32,
                               cross_impl=impl, kv_quant=True,
                               weight_quant=True)
    assert any("weight_quant" in str(x.message) for x in w)
    assert out["num_steps"] == 1
    pre = pd.quantize_decoder_weights(tp)
    with pytest.raises(ValueError, match="pre-quantized"):
        pd.greedy_decode(pre, tb, dims, compute_dtype=torch.float32,
                         cross_impl=impl)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # "auto" neither warns nor raises
        pd.greedy_decode(pre, tb, dims, compute_dtype=torch.float32)


# ---------------------------------------------------------- gqa_self_impl
@pytest.mark.parametrize("gqa_self_impl", ["expand", "grouped"])
@pytest.mark.parametrize("impl,kv_quant", [("xla", False), ("xla", True),
                                           ("mxu", True)])
def test_gqa_self_impl_f32_token_exact_vs_jax(impl, kv_quant, gqa_self_impl):
    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, MODEL=dataclasses.replace(
        cfg.MODEL, NUM_HEAD=4, NUM_KV_HEAD=2, NUM_MODEL=16))
    jdims = JaxDims.from_config(cfg)
    assert jdims.kv_groups == 2
    from plankassembly_tpu.models.model import init_params
    params = jax.tree.map(np.asarray, init_params(
        jax.random.key(4, impl="threefry2x32"), jdims))
    batch = {k: v for k, v in random_batch(cfg, batch_size=4, seed=4).items()
             if k.startswith("input")}
    jp, jb = _jax(params, batch)
    ref = jd.greedy_decode(jp, jb, jdims, compute_dtype=jnp.float32,
                           cross_impl=impl, kv_quant=kv_quant,
                           gqa_self_impl=gqa_self_impl)
    tp, tb = _port(params, batch)
    got = pd.greedy_decode(tp, tb, ModelDims.from_config(cfg),
                           compute_dtype=torch.float32, cross_impl=impl,
                           kv_quant=kv_quant, gqa_self_impl=gqa_self_impl)
    _assert_same(got, ref)


def test_unknown_gqa_self_impl_raises():
    cfg, jdims, params, batch = _setup(1)
    tp, tb = _port(params, batch)
    with pytest.raises(ValueError, match="gqa_self_impl"):
        pd.greedy_decode(tp, tb, ModelDims.from_config(cfg),
                         gqa_self_impl="bogus")


# --------------------------------------------------------- no-cache decode
@pytest.mark.parametrize("early_exit", [True, False], ids=["exit", "full"])
@pytest.mark.parametrize("kv", [0, 1], ids=["mha", "gqa"])
def test_nocache_f32_token_exact_vs_jax_and_cached(kv, early_exit):
    """The no-cache decode gives JAX's no-cache samples, attach and
    num_steps, and the port's cached full-precision decode's."""
    seed, bias = END_CASES["staggered"][kv]
    cfg, jdims, params, batch = _setup(kv, bias, seed=seed)
    jp, jb = _jax(params, batch)
    ref = jd.greedy_decode_nocache(jp, jb, jdims, compute_dtype=jnp.float32,
                                   early_exit=early_exit)
    tp, tb = _port(params, batch)
    dims = ModelDims.from_config(cfg)
    got = pd.greedy_decode_nocache(tp, tb, dims, compute_dtype=torch.float32,
                                   early_exit=early_exit)
    _assert_same(got, ref)
    cached = pd.greedy_decode(tp, tb, dims, compute_dtype=torch.float32,
                              cross_impl="xla", early_exit=early_exit)
    _assert_same(got, {k: np.asarray(v) if torch.is_tensor(v) else v
                       for k, v in cached.items()})
    if early_exit:
        assert got["num_steps"] < dims.max_output_length


def test_eval_step_matches_jax():
    seed, bias = END_CASES["staggered"][1]
    cfg, jdims, params, _ = _setup(1, bias, seed=seed)
    batch = random_batch(cfg, batch_size=4, seed=seed)
    batch = {k: v for k, v in batch.items()
             if k.startswith("input") or k == "output_value"}
    jp, jb = _jax(params, batch)
    ref = jd.eval_step(jp, jb, jdims, compute_dtype=jnp.float32)
    tp, tb = _port(params, batch)
    got = pd.eval_step(tp, tb, ModelDims.from_config(cfg),
                       compute_dtype=torch.float32)
    np.testing.assert_array_equal(got["samples"], ref["samples"])
    np.testing.assert_array_equal(got["attach"], ref["attach"])
    assert got["num_steps"] == ref["num_steps"]
    for key in ("predicts", "groundtruths"):
        assert len(got[key]) == len(ref[key])
        for a, b in zip(got[key], ref[key]):
            np.testing.assert_array_equal(a, b)
