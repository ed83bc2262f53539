"""The port's MHA decode paths (`plankassembly_tpu_torch/decode.py`:
`decode_from_memory` with cross_impl "xla", "mxu", "kernel" and "fused")
against the JAX package on the tiny config (float32 token for token,
bfloat16 at the repo's agreement bar), the routing rules around them, and
ep59's weights."""
import dataclasses
import os
import warnings

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from plankassembly_tpu.config import config_from_hparams_file as jax_config
from plankassembly_tpu.decode import decode_from_memory as jax_dfm
from plankassembly_tpu.decode import greedy_decode as jax_greedy_decode
from plankassembly_tpu.models.model import ModelDims as JaxDims
from plankassembly_tpu.models.model import encode as jax_encode
from plankassembly_tpu.models.model import init_params
from plankassembly_tpu_torch import checkpoint as port_ckpt
from plankassembly_tpu_torch import decode as port_decode
from plankassembly_tpu_torch import serving
from plankassembly_tpu_torch.config import ModelDims, config_from_hparams_file
from plankassembly_tpu_torch.ops import cross_decode as CD
from tests.test_torch_decode import END_CASES, _port, _setup

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MHA = os.path.join(ROOT, "checkpoints", "mha_complete_ep59")

# (port cross_impl, JAX cross_impl, kv_quant, self_quant)
PATHS = {
    "xla": ("xla", "xla", False, None),
    "xla_int8": ("xla", "xla", True, None),
    "mxu": ("mxu", "mxu", False, None),
    "mxu_int8": ("mxu", "mxu", True, None),       # int8 self K/V too
    "mxu_int8_self_off": ("mxu", "mxu", True, False),
    "mxu_self_only": ("mxu", "mxu", False, True),
    "kernel": ("kernel", "kernel-interpret", False, None),
    "kernel_int8": ("kernel", "kernel-interpret", True, None),
    "fused": ("fused", "fused-interpret", None, None),
}


def _memory(kv, end):
    seed, bias = END_CASES[end][kv]
    cfg, jdims, params, batch = _setup(kv, bias, seed=seed)
    jparams = jax.tree.map(jnp.asarray, params)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    memory = jax_encode(jparams, jbatch, jdims, compute_dtype=jnp.float32)
    tparams, tbatch = _port(params, batch)
    return (cfg, jdims, jparams, jbatch, memory, tparams,
            torch.from_numpy(np.array(memory)), tbatch)


@pytest.mark.parametrize("end", ["none", "staggered"])
@pytest.mark.parametrize("path", list(PATHS))
def test_decode_from_memory_f32_token_exact_vs_jax(path, end):
    """The same algorithm on both sides in float32: samples, attach and
    num_steps identical (no tolerance)."""
    impl, jimpl, kv_quant, self_quant = PATHS[path]
    cfg, jdims, jparams, jbatch, memory, tparams, tmemory, tbatch = \
        _memory(0, end)
    ref = jax_dfm(jparams, memory, jbatch["input_mask"], jdims,
                  compute_dtype=jnp.float32, kv_quant=kv_quant,
                  cross_impl=jimpl, self_quant=self_quant)
    got = port_decode.decode_from_memory(
        tparams, tmemory, tbatch["input_mask"], ModelDims.from_config(cfg),
        compute_dtype=torch.float32, kv_quant=kv_quant, cross_impl=impl,
        self_quant=self_quant)
    np.testing.assert_array_equal(got["samples"].numpy(),
                                  np.asarray(ref["samples"]))
    np.testing.assert_array_equal(got["attach"].numpy(),
                                  np.asarray(ref["attach"]))
    assert got["num_steps"] == int(ref["num_steps"])


@pytest.mark.parametrize("path", list(PATHS))
def test_decode_from_memory_bf16_meets_the_repo_bar(path):
    """In bfloat16 the frameworks round at other points; the bar the repo
    holds kernel variants to is token agreement >= 0.99
    (`tests/test_persistent_decode.py`), with the same step count."""
    impl, jimpl, kv_quant, self_quant = PATHS[path]
    cfg, jdims, jparams, jbatch, memory, tparams, tmemory, tbatch = \
        _memory(0, "none")
    ref = jax_dfm(jparams, memory, jbatch["input_mask"], jdims,
                  compute_dtype=jnp.bfloat16, kv_quant=kv_quant,
                  cross_impl=jimpl, self_quant=self_quant)
    got = port_decode.decode_from_memory(
        tparams, tmemory, tbatch["input_mask"], ModelDims.from_config(cfg),
        compute_dtype=torch.bfloat16, kv_quant=kv_quant, cross_impl=impl,
        self_quant=self_quant)
    a, b = got["samples"].numpy(), np.asarray(ref["samples"])
    assert float((a == b).mean()) >= 0.99, (a, b)
    assert got["num_steps"] == int(ref["num_steps"])


@pytest.mark.parametrize("impl", ["kernel", "fused"])
def test_full_bound_without_early_exit(impl):
    """early_exit=False runs all S steps, as JAX's benchmark mode."""
    jimpl = impl + "-interpret"
    cfg, jdims, jparams, jbatch, memory, tparams, tmemory, tbatch = \
        _memory(0, "staggered")
    ref = jax_dfm(jparams, memory, jbatch["input_mask"], jdims,
                  compute_dtype=jnp.float32, kv_quant=True, cross_impl=jimpl,
                  early_exit=False)
    got = port_decode.decode_from_memory(
        tparams, tmemory, tbatch["input_mask"], ModelDims.from_config(cfg),
        compute_dtype=torch.float32, kv_quant=True, cross_impl=impl,
        early_exit=False)
    np.testing.assert_array_equal(got["samples"].numpy(),
                                  np.asarray(ref["samples"]))
    assert got["num_steps"] == int(ref["num_steps"]) == \
        cfg.DATA.MAX_OUTPUT_LENGTH


@pytest.mark.parametrize("impl", ["kernel", "fused"])
def test_greedy_decode_routes_by_cross_impl(impl):
    """greedy_decode with a kv bucket wider than the packed input reaches
    the same path as JAX's greedy_decode."""
    seed, bias = END_CASES["staggered"][0]
    cfg, jdims, params, batch = _setup(0, bias, seed=seed)
    ref = jax_greedy_decode(
        jax.tree.map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()}, jdims,
        compute_dtype=jnp.float32, kv_bucket=64, kv_quant=True,
        cross_impl=impl + "-interpret")
    tparams, tbatch = _port(params, batch)
    got = port_decode.greedy_decode(
        tparams, tbatch, ModelDims.from_config(cfg),
        compute_dtype=torch.float32, kv_bucket=64, kv_quant=True,
        cross_impl=impl)
    np.testing.assert_array_equal(got["samples"].numpy(),
                                  np.asarray(ref["samples"]))
    assert got["num_steps"] == int(ref["num_steps"])


def test_kernel_path_calls_the_kernel_for_mha_only(monkeypatch):
    """MHA "kernel" goes through cross_attn_decode once per layer and step;
    a grouped-query model falls back to the einsum path on the CPU (JAX's
    rule off its TPU) and gives JAX's tokens."""
    calls = []
    real = CD.cross_attn_decode

    def counting(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(CD, "cross_attn_decode", counting)
    for kv in (0, 1):
        calls.clear()
        cfg, jdims, jparams, jbatch, memory, tparams, tmemory, tbatch = \
            _memory(kv, "staggered")
        dims = ModelDims.from_config(cfg)
        got = port_decode.decode_from_memory(
            tparams, tmemory, tbatch["input_mask"], dims,
            compute_dtype=torch.float32, kv_quant=True, cross_impl="kernel")
        ref = jax_dfm(jparams, memory, jbatch["input_mask"], jdims,
                      compute_dtype=jnp.float32, kv_quant=True,
                      cross_impl="kernel-interpret")
        np.testing.assert_array_equal(got["samples"].numpy(),
                                      np.asarray(ref["samples"]))
        B = tmemory.shape[0]
        if kv == 0:
            # steps run include those past the exit, up to the next check
            steps = -(-got["num_steps"] // port_decode.CHECK_EVERY) * \
                port_decode.CHECK_EVERY
            assert len(calls) == dims.num_decoder_layers * min(
                steps, dims.max_output_length)
            assert calls[0] == (B * dims.num_head, dims.head_dim)
        else:
            assert calls == []


def test_fused_rejects_gqa_and_unchunkable_memory():
    cfg, _, _, _, _, tparams, tmemory, tbatch = _memory(1, "none")
    with pytest.raises(ValueError, match="requires MHA"):
        port_decode.decode_from_memory(
            tparams, tmemory, tbatch["input_mask"], ModelDims.from_config(cfg),
            compute_dtype=torch.float32, cross_impl="fused")
    cfg, _, _, _, _, tparams, _, _ = _memory(0, "none")
    dims = ModelDims.from_config(cfg)
    memory = torch.randn(2, 130, dims.num_model)
    mask = torch.zeros(2, 130, dtype=torch.bool)
    with pytest.raises(ValueError, match=r"Li % 128 == 0, got 130"):
        port_decode.decode_from_memory(tparams, memory, mask, dims,
                                       compute_dtype=torch.float32,
                                       cross_impl="fused")


def test_unknown_cross_impl_and_persistent_flags():
    cfg, _, _, _, _, tparams, tmemory, tbatch = _memory(0, "none")
    dims = ModelDims.from_config(cfg)
    for bad in ("kernel-interpret", "einsum"):
        with pytest.raises(ValueError, match="unknown cross_impl"):
            port_decode.decode_from_memory(tparams, tmemory,
                                           tbatch["input_mask"], dims,
                                           cross_impl=bad)
        with pytest.raises(ValueError, match="unknown cross_impl"):
            port_decode.greedy_decode(tparams, tbatch, dims, cross_impl=bad)
    with pytest.warns(UserWarning, match="ignored"):
        port_decode.decode_from_memory(tparams, tmemory, tbatch["input_mask"],
                                       dims, compute_dtype=torch.float32,
                                       kv_quant=False,
                                       cross_impl="persistent")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        port_decode.decode_from_memory(tparams, tmemory, tbatch["input_mask"],
                                       dims, compute_dtype=torch.float32,
                                       kv_quant=True,
                                       cross_impl="persistent")


@pytest.mark.parametrize("impl", ["kernel", "fused"])
def test_live_backend_serves_the_named_path(impl):
    """make_live_backend(cross_impl=...) decodes with kv_quant=True on the
    named path: the same rows as greedy_decode called directly."""
    seed, bias = END_CASES["staggered"][0]
    cfg, _, params, batch = _setup(0, bias, seed=seed)
    tparams, tbatch = _port(params, batch)
    dims = ModelDims.from_config(cfg)
    direct = port_decode.greedy_decode(
        tparams, tbatch, dims, compute_dtype=torch.float32, kv_bucket=32,
        kv_quant=True, cross_impl=impl)
    backend, _ = serving.make_live_backend(
        tparams, cfg, batch=4, bucket=32, compute_dtype=torch.float32,
        device="cpu", cross_impl=impl)
    out = backend({k: np.asarray(v) for k, v in batch.items()})
    np.testing.assert_array_equal(out["samples"], direct["samples"].numpy())
    np.testing.assert_array_equal(out["attach"], direct["attach"].numpy())


def test_ep59_weights_round_trip_and_load_bit_exact():
    """Parameters at ep59's dims (MHA, d=512, 6+6 layers) survive the
    port's conversion both ways, and the shipped ep59 file loads to the
    same float32 bits as the JAX package's ml_dtypes path."""
    jcfg = jax_config(MHA + ".hparams.yaml")
    jdims = JaxDims.from_config(jcfg)
    dims = ModelDims.from_config(config_from_hparams_file(
        MHA + ".hparams.yaml"))
    assert dataclasses.asdict(dims) == dataclasses.asdict(jdims)
    assert (dims.num_head, dims.kv_heads, dims.num_model) == (8, 8, 512)
    tree = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(0), jdims))
    back = port_ckpt.params_to_numpy(port_ckpt.params_from_jax(tree))
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(flat_b[path], a)
    ours = port_ckpt.load_npz(MHA + ".npz")
    with np.load(MHA + ".npz") as z:
        keys = [k for k in z.files if k != "__step__"]
        assert len(keys) == len(flat_a)
        for key in keys:
            ref = z[key].view(ml_dtypes.bfloat16).astype(np.float32)
            node = ours
            for part in key.split("/"):
                node = node[part]
            np.testing.assert_array_equal(
                node.float().numpy().view(np.uint32), ref.view(np.uint32))
