"""The port's greedy decode (plain version of the CUDA decode loop) against
the JAX package on the tiny config (`plankassembly_tpu_torch/decode.py`,
`ops/persistent_decode.py`)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plankassembly_tpu.decode import greedy_decode as jax_greedy_decode
from plankassembly_tpu.decode import pick_kv_bucket as jax_pick_kv_bucket
from plankassembly_tpu.decode import parse_sequence as jax_parse_sequence
from plankassembly_tpu.models.model import (
    ModelDims as JaxDims, encode as jax_encode, init_params,
)
from plankassembly_tpu.ops.persistent_decode import (
    persistent_greedy_decode as jax_persistent,
)
from plankassembly_tpu_torch.checkpoint import params_from_jax
from plankassembly_tpu_torch.config import ModelDims
from plankassembly_tpu_torch.decode import (
    greedy_decode, parse_sequence, pick_kv_bucket,
)
from plankassembly_tpu_torch.ops import persistent_decode as port_pd
from tests.tiny import random_batch, tiny_config

# (init seed, END-logit offset) per kv layout: "none" leaves the random
# model as it is (no row ends, so early exit never fires), "all_at_once"
# ends every row at t=0, and "staggered" ends the rows at different steps
# (MHA: 2, 3, 3, 5; GQA: 2, 0, 1, 2), so rows that finished earlier keep
# decoding trailing tokens until the last one ends.
END_CASES = {"none": {0: (0, 0.0), 1: (0, 0.0)},
             "staggered": {0: (3, 0.6), 1: (3, 0.8)},
             "all_at_once": {0: (0, 1e4), 1: (0, 1e4)}}


def _setup(kv, end_bias=0.0, seed=0, batch_size=4):
    cfg = tiny_config()
    cfg = dataclasses.replace(
        cfg, MODEL=dataclasses.replace(cfg.MODEL, NUM_KV_HEAD=kv))
    jdims = JaxDims.from_config(cfg)
    # threefry whatever the process's default: a JAX Trainer built earlier
    # in the same test worker switches the default to "rbg", whose init
    # gives other programs (and other exit steps) than these cases expect
    params = init_params(jax.random.key(seed, impl="threefry2x32"), jdims)
    params = jax.tree.map(np.asarray, params)
    params["heads"]["vocab"]["b"] = params["heads"]["vocab"]["b"].copy()
    params["heads"]["vocab"]["b"][cfg.TOKEN.END] += end_bias
    batch = {k: v for k, v in
             random_batch(cfg, batch_size=batch_size, seed=seed).items()
             if k.startswith("input")}
    return cfg, jdims, params, batch


def _port(params, batch):
    return (params_from_jax(params),
            {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})


@pytest.mark.parametrize("kv", [0, 1], ids=["mha", "gqa"])
@pytest.mark.parametrize("end", list(END_CASES))
@pytest.mark.parametrize("early_exit", [True, False], ids=["exit", "full"])
def test_greedy_decode_f32_token_exact_vs_jax_xla(kv, end, early_exit):
    """Same algorithm on both sides in float32: samples, attach and
    num_steps must be identical (no tolerance)."""
    seed, bias = END_CASES[end][kv]
    cfg, jdims, params, batch = _setup(kv, bias, seed=seed)
    ref = jax_greedy_decode(
        jax.tree.map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()}, jdims,
        compute_dtype=jnp.float32, early_exit=early_exit, kv_quant=True,
        self_quant=False, cross_impl="xla")
    tparams, tbatch = _port(params, batch)
    got = greedy_decode(tparams, tbatch, ModelDims.from_config(cfg),
                        compute_dtype=torch.float32, early_exit=early_exit,
                        cross_impl="persistent")
    np.testing.assert_array_equal(got["samples"].numpy(),
                                  np.asarray(ref["samples"]))
    np.testing.assert_array_equal(got["attach"].numpy(),
                                  np.asarray(ref["attach"]))
    assert got["num_steps"] == int(ref["num_steps"])
    if end == "staggered" and early_exit:
        # the case exercises what it names: rows end at different steps
        ends = [np.flatnonzero(r == cfg.TOKEN.END)[:1] for r in
                got["samples"].numpy()]
        firsts = {int(e[0]) if e.size else -1 for e in ends}
        assert len(firsts) > 1 and -1 not in firsts, firsts
        assert got["num_steps"] < cfg.DATA.MAX_OUTPUT_LENGTH


@pytest.mark.parametrize("kv", [0, 1], ids=["mha", "gqa"])
def test_reference_meets_the_persistent_kernels_bar(kv):
    """Against the Pallas kernel in interpret mode, the bar
    `tests/test_persistent_decode.py` holds that kernel to: token agreement
    >= 0.99 and identical attach on identical rows (it folds the int8
    scales and keeps a bf16 hidden cache, so rounding may differ)."""
    cfg, jdims, params, batch = _setup(kv)
    jparams = jax.tree.map(jnp.asarray, params)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    memory = jax_encode(jparams, jbatch, jdims, compute_dtype=jnp.float32)
    ref = jax_persistent(jparams, memory, jbatch["input_mask"], jdims,
                         block_rows=2, compute_dtype=jnp.float32,
                         interpret=True)
    tparams, tbatch = _port(params, batch)
    got = port_pd.greedy_decode_reference(
        tparams, torch.from_numpy(np.array(memory)), tbatch["input_mask"],
        ModelDims.from_config(cfg), compute_dtype=torch.float32,
        early_exit=False)
    a, b = got["samples"].numpy(), np.asarray(ref["samples"])
    assert float((a == b).mean()) >= 0.99, (a, b)
    same = (a == b).all(axis=-1)
    np.testing.assert_array_equal(got["attach"].numpy()[same],
                                  np.asarray(ref["attach"])[same])


def test_kv_bucket_crop_and_pad_match_jax():
    """A bucket narrower than the packed width crops it, a wider one pads
    masked PAD columns; both give the JAX results."""
    seed, bias = END_CASES["staggered"][1]
    cfg, jdims, params, batch = _setup(1, bias, seed=seed)
    tparams, tbatch = _port(params, batch)
    dims = ModelDims.from_config(cfg)
    for bucket in (28, 40):
        ref = jax_greedy_decode(
            jax.tree.map(jnp.asarray, params),
            {k: jnp.asarray(v) for k, v in batch.items()}, jdims,
            compute_dtype=jnp.float32, kv_bucket=bucket, kv_quant=True,
            self_quant=False, cross_impl="xla")
        got = greedy_decode(tparams, tbatch, dims,
                            compute_dtype=torch.float32, kv_bucket=bucket,
                            cross_impl="persistent")
        np.testing.assert_array_equal(got["samples"].numpy(),
                                      np.asarray(ref["samples"]))
        assert got["num_steps"] == int(ref["num_steps"])


def test_persistent_decode_cpu_uses_reference_and_counts_nothing():
    cfg, jdims, params, batch = _setup(1)
    tparams, tbatch = _port(params, batch)
    dims = ModelDims.from_config(cfg)
    memory = torch.randn(4, batch["input_value"].shape[1], dims.num_model)
    before = port_pd.launches
    a = port_pd.persistent_greedy_decode(tparams, memory,
                                         tbatch["input_mask"], dims,
                                         compute_dtype=torch.float32)
    b = port_pd.greedy_decode_reference(tparams, memory, tbatch["input_mask"],
                                        dims, compute_dtype=torch.float32)
    assert port_pd.launches == before
    assert torch.equal(a["samples"], b["samples"])
    with pytest.raises(ValueError, match="memory_mask"):
        port_pd.persistent_greedy_decode(tparams, memory,
                                         tbatch["input_mask"][:, :5], dims)


def test_pick_kv_bucket_and_parse_sequence_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(20):
        lens = rng.integers(1, 1199, size=rng.integers(1, 9))
        mask = np.arange(1199)[None, :] >= lens[:, None]
        assert pick_kv_bucket(torch.from_numpy(mask)) == \
            jax_pick_kv_bucket(mask)
    dims = ModelDims.from_config(tiny_config())
    jdims = JaxDims.from_config(tiny_config())
    for _ in range(20):
        seq = rng.integers(0, 514, size=24)
        np.testing.assert_array_equal(parse_sequence(seq, dims),
                                      jax_parse_sequence(seq, jdims))
