"""The port's parallel layer (`plankassembly_tpu_torch/parallel/`) against
JAX's mesh on the CPU.

The same numpy-seeded parameters (biases included, so a bias added once
per rank would show) and a batch whose rows hold unequal token counts go
through JAX's training step under `make_mesh(8, 1)` and `make_mesh(4, 2)`
on conftest's 8 virtual devices, and through the port's step in gloo
process groups of dp=2, tp=2 and dp=2 x tp=2 (one spawn of 4 worker
processes, `tests/torch_dist_worker.py`, forming its worlds in turn).
Float32 throughout; the tiny MHA config (2 heads) and a tiny GQA variant
(4 query heads over 2 kv heads, so tp=2 splits the kv heads).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from plankassembly_tpu.models.model import ModelDims as JaxDims
from plankassembly_tpu.models.model import init_params as jax_init
from plankassembly_tpu.parallel.mesh import (
    _spec_for_path as jax_spec_for_path, make_mesh as jax_mesh,
    shard_batch as jax_shard_batch, shard_params as jax_shard_params,
)
from plankassembly_tpu.train.state import (
    init_state as jax_init_state, make_train_step as jax_make_step,
)
from plankassembly_tpu_torch.checkpoint import params_from_jax
from plankassembly_tpu_torch.config import ModelDims, write_hparams_yaml
from plankassembly_tpu_torch.models.model import train_step_loss
from plankassembly_tpu_torch.models.vit import VitDims, init_vit_params
from plankassembly_tpu_torch.parallel import mesh as port_mesh
from plankassembly_tpu_torch.train.state import tree_leaves
from tests.test_torch_train_e2e import _port_cfg
from tests.tiny import random_batch, tiny_config
from tests.torch_dist_worker import spawn

LR = 1e-3
ROWS = 8
# tests/test_parallel.py's bounds for JAX's own mesh against one device
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-5
VIT = VitDims(image_size=64, patch_size=16)
MHA = dict(NUM_HEAD=2, NUM_KV_HEAD=0)
GQA = dict(NUM_HEAD=4, NUM_KV_HEAD=2)


def _cfg(model):
    cfg = tiny_config()
    return dataclasses.replace(cfg, LR=LR, MODEL=dataclasses.replace(
        cfg.MODEL, DROPOUT=0.0, **model))


def _params(cfg):
    """JAX's parameter tree filled from numpy (seed 0), biases nonzero."""
    rng = np.random.default_rng(0)
    shapes = jax_init(jax.random.PRNGKey(0), JaxDims.from_config(cfg))
    return jax.tree.map(lambda a: (0.3 * rng.standard_normal(a.shape))
                        .astype(np.float32), shapes)


def _batch(cfg):
    """8 rows; rows 4-7 (the second data rank's under dp=2) hold far fewer
    output tokens, rows 2 and 5 fewer input tokens."""
    b = random_batch(cfg, batch_size=ROWS, seed=3)
    pad = cfg.TOKEN.PAD
    for row, n in ((4, 5), (5, 7), (6, 3), (7, 9)):
        b["output_mask"][row, n:] = True
        b["output_value"][row, n:] = pad
        b["output_label"][row, n:] = pad
    for row, n in ((2, 11), (5, 20)):
        b["input_mask"][row, n:] = True
        b["input_value"][row, n:] = pad
    return b


def _jax_step(cfg, params, batch, mesh_shape):
    dims = JaxDims.from_config(cfg)
    opt = optax.adam(LR)
    step = jax_make_step(opt, dims, compute_dtype=jnp.float32, donate=False)
    mesh = jax_mesh(*mesh_shape)
    tp = mesh_shape[1] > 1
    state = jax_init_state(jax_shard_params(
        jax.tree.map(jnp.asarray, params), mesh, tp), opt)
    jb = jax_shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh)
    with mesh:
        state, mets = step(state, jb, jax.random.PRNGKey(7))
    flat = {"/".join(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_leaves_with_path(state.params)}
    return float(mets["loss"]), flat


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    files = {}
    for name, model in (("mha", MHA), ("gqa", GQA)):
        cfg = _cfg(model)
        params = _params(cfg)
        files[name] = {"cfg": cfg, "params": params,
                       "yaml": str(tmp / f"{name}.yaml"),
                       "npz": str(tmp / f"{name}.npz")}
        write_hparams_yaml(_port_cfg(cfg), files[name]["yaml"])
        np.savez(files[name]["npz"], **{
            "/".join(p): t.numpy() for p, t in
            tree_leaves(params_from_jax(params))})
    batch = _batch(files["mha"]["cfg"])
    np.savez(tmp / "batch.npz", **batch)
    # the raster/ViT variant: the MHA config's decoder behind a patch
    # encoder of 3 x (64/16)^2 tokens, on random images
    vit_params = init_vit_params(torch.Generator().manual_seed(1),
                                 ModelDims.from_config(_port_cfg(
                                     files["mha"]["cfg"])), VIT)
    np.savez(tmp / "vit.npz", **{"/".join(p): t.numpy()
                                 for p, t in tree_leaves(vit_params)})
    images = np.random.default_rng(2).random(
        (ROWS, 3, VIT.image_size, VIT.image_size)).astype(np.float32)
    np.savez(tmp / "raster_batch.npz", input_image=images, **{
        k: v for k, v in batch.items() if k.startswith("output")})
    world_no = [0]

    def world(size):
        world_no[0] += 1
        return f"file://{tmp}/rdv{world_no[0]}", size

    def jobs(tag, model, size, **kw):
        """One job per rank of a `size`-rank world (one process: size 0)."""
        init, n = world(size) if size else (None, 0)
        common = dict(cfg=files[model]["yaml"], params=files[model]["npz"],
                      batch=str(tmp / "batch.npz"), **kw)
        if tag.startswith("vit"):
            common.update(params=str(tmp / "vit.npz"),
                          batch=str(tmp / "raster_batch.npz"),
                          raster=[VIT.image_size, VIT.patch_size])
        if not size:
            return [{"fn": "step", "out": str(tmp / f"{tag}.npz"),
                     "args": common}]
        return [{"fn": "step", "out": str(tmp / f"{tag}.r{r}.npz"),
                 "args": dict(common, init=init, world=n, rank=r)}
                for r in range(n)]

    def seq(tag, size):
        init, n = world(size) if size else (None, 0)
        args = dict(cfg=files["mha"]["yaml"], params=files["mha"]["npz"],
                    batch=str(tmp / "batch.npz"), num_seq=max(1, size))
        if not size:
            return [{"fn": "seq_encoder", "out": str(tmp / f"{tag}.npz"),
                     "args": args}]
        return [{"fn": "seq_encoder", "out": str(tmp / f"{tag}.r{r}.npz"),
                 "args": dict(args, init=init, world=n, rank=r)}
                for r in range(n)]

    d02 = dict(dropout=0.2)
    phases = [
        jobs("dp2tp2", "mha", 4, num_data=2, num_model=2),
        jobs("dp2tp2_d02", "mha", 4, num_data=2, num_model=2, **d02),
        jobs("dp2", "mha", 2, num_data=2) + jobs("tp2", "mha", 2,
                                                 num_model=2),
        jobs("dp2_d02", "mha", 2, num_data=2, **d02)
        + jobs("tp2_d02", "mha", 2, num_model=2, **d02),
        jobs("dp2_d02_plain", "mha", 2, num_data=2, flash=False, **d02)
        + jobs("tp2_d02_plain", "mha", 2, num_model=2, flash=False, **d02),
        jobs("gqa_tp2", "gqa", 2, num_model=2)
        + jobs("gqa_tp2_d02", "gqa", 2, num_model=2, **d02),
        seq("seq2", 2) + jobs("one_d02", "mha", 0, **d02)
        + jobs("one_d02_plain", "mha", 0, flash=False, **d02),
        jobs("gqa_one_d02", "gqa", 0, **d02) + seq("seq1", 0)
        + jobs("vit_tp2_d02", "mha", 2, num_model=2, **d02),
        jobs("vit_one_d02", "mha", 0, **d02)
        + jobs("vit_dp2_d02", "mha", 2, num_data=2, **d02),
    ]
    spawn(phases, tmp)

    def load(tag):
        with np.load(tmp / f"{tag}.npz") as z:
            return {k: z[k] for k in z.files}

    return {"load": load, "files": files, "batch": batch}


def _assert_step_matches(got, loss, params, init):
    np.testing.assert_allclose(got["loss"][0], loss, rtol=LOSS_RTOL)
    for name, ref in params.items():
        mine = got["param/" + name]
        if name.endswith("/bk"):
            # exact gradient 0: Adam turns rounding noise into steps of
            # at most lr (tests/test_torch_train_model.py)
            for p in (mine, ref):
                assert np.abs(p - init[name]).max() <= LR * 1.01, name
            continue
        np.testing.assert_allclose(mine, ref, atol=PARAM_ATOL, err_msg=name)


def _jax_flat(params):
    return {"/".join(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_leaves_with_path(params)}


@pytest.mark.parametrize("tag,model,jax_shape", [
    ("dp2", "mha", (8, 1)),
    ("tp2", "mha", (4, 2)),
    ("dp2tp2", "mha", (4, 2)),
    ("gqa_tp2", "gqa", (4, 2)),
])
def test_step_matches_jax_mesh(runs, tag, model, jax_shape):
    """One Adam step of the global batch: the loss, and every gathered
    parameter, against JAX's step under its mesh; every rank reports the
    same global loss."""
    f = runs["files"][model]
    loss, params = _jax_step(f["cfg"], f["params"], runs["batch"], jax_shape)
    ranks = 4 if tag == "dp2tp2" else 2
    got = [runs["load"](f"{tag}.r{r}") for r in range(ranks)]
    init = _jax_flat(f["params"])
    _assert_step_matches(got[0], loss, params, init)
    for g in got[1:]:
        assert g["loss"][0] == got[0]["loss"][0]
        for name in params:
            np.testing.assert_array_equal(g["param/" + name],
                                          got[0]["param/" + name])


@pytest.mark.parametrize("tag,model", [("tp2", "mha"), ("dp2tp2", "mha"),
                                       ("gqa_tp2", "gqa")])
def test_tp_split_axes(runs, tag, model):
    """Each rank holds whole heads: wq/wk/wv/bq/bk/bv and w1/b1 split on
    their output axis, wo/w2 on their input axis, the rest whole; the rule
    names JAX's axis for every leaf."""
    f = runs["files"][model]
    dims = ModelDims.from_config(_port_cfg(f["cfg"]))
    got = runs["load"](f"{tag}.r0")
    whole = {n: a.shape for n, a in _jax_flat(f["params"]).items()}
    for name, shape in whole.items():
        axis = port_mesh.spec_for_path(name, True)
        jspec = jax_spec_for_path("".join(f"['{p}']" for p in
                                          name.split("/")), True)
        jaxis = [i - len(shape) for i, a in enumerate(jspec) if a]
        assert jaxis == ([] if axis is None else [axis]), name
        want = list(shape)
        if axis is not None:
            want[axis] //= 2
        assert list(got["shape/" + name]) == want, name
    kv_cols = got["shape/encoder/self_attn/wk"][-1]
    assert kv_cols == dims.kv_heads // 2 * dims.head_dim
    assert got["shape/decoder/ffn/w2"][-2] == dims.num_feedforward // 2
    assert list(got["shape/decoder/cross_attn/bo"]) == list(
        whole["decoder/cross_attn/bo"])


@pytest.mark.parametrize("tag,one", [
    ("dp2_d02", "one_d02"), ("tp2_d02", "one_d02"),
    ("dp2tp2_d02", "one_d02"), ("gqa_tp2_d02", "gqa_one_d02"),
    ("dp2_d02_plain", "one_d02_plain"), ("tp2_d02_plain", "one_d02_plain"),
    ("vit_tp2_d02", "vit_one_d02"), ("vit_dp2_d02", "vit_one_d02"),
])
def test_dropout_step_equals_one_process(runs, tag, one):
    """At dropout 0.2 the masks are the one-process run's (drawn at the
    global shapes and sliced; the fused attention's seed folded by the
    rank's row and head offsets): the same loss and updated parameters as
    one process with the same seed, through the fused attention's plain
    version and through the plain attention path; the raster/ViT loss too,
    its patch projection replicated."""
    got, ref = runs["load"](f"{tag}.r0"), runs["load"](one)
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["accuracy"], ref["accuracy"], atol=1e-7)
    for key in ref:
        if key.startswith("param/") and not key.endswith("/bk"):
            np.testing.assert_allclose(got[key], ref[key], atol=PARAM_ATOL,
                                       err_msg=key)
    if tag.startswith("vit_tp2"):
        assert list(got["shape/embed/patch"]) == list(
            ref["shape/embed/patch"])
        assert got["shape/encoder/ffn/w1"][-1] * 2 == \
            ref["shape/encoder/ffn/w1"][-1]


def test_loss_normalization_with_unequal_token_counts(runs):
    """The data ranks hold 76 and 24 real tokens: the step's loss is the
    global token-weighted mean (equal to JAX's), not the mean of the two
    ranks' means, which misses it by more than ten times the tolerance."""
    f = runs["files"]["mha"]
    r0, r1 = runs["load"]("dp2.r0"), runs["load"]("dp2.r1")
    assert int(r0["tokens"]) > 2 * int(r1["tokens"]) > 0
    loss, _ = _jax_step(f["cfg"], f["params"], runs["batch"], (8, 1))
    np.testing.assert_allclose(r0["loss"][0], loss, rtol=LOSS_RTOL)
    dims = ModelDims.from_config(_port_cfg(f["cfg"]))
    tree = params_from_jax(f["params"])
    halves = []
    for lo, hi in ((0, 4), (4, 8)):
        rows = {k: torch.from_numpy(v[lo:hi])
                for k, v in runs["batch"].items()}
        half, _ = train_step_loss(tree, rows, dims, deterministic=True,
                                  compute_dtype=torch.float32)
        halves.append(half.item())
    assert abs(np.mean(halves) - loss) > 10 * LOSS_RTOL * loss


def test_seq_parallel_encoder_matches_one_process(runs):
    """The encoder with its length axis split over 2 ranks (31 tokens
    padded to 32, 16 query rows a rank against all 32 keys): the memory
    and the encoder's and embeddings' gradients summed over the seq group
    equal one process's in f32."""
    one = runs["load"]("seq1")
    for r in range(2):
        got = runs["load"](f"seq2.r{r}")
        assert got["memory"].shape == one["memory"].shape
        np.testing.assert_allclose(got["memory"], one["memory"], atol=1e-5)
        for key in one:
            if key.startswith("grad/"):
                np.testing.assert_allclose(got[key], one[key], atol=1e-4,
                                           rtol=1e-4, err_msg=key)


def test_mesh_rules_in_one_process():
    """JAX's mesh error when the mesh outgrows the processes; the whole-head
    rule; a trivial mesh shards and gathers nothing."""
    with pytest.raises(ValueError, match="mesh needs 2 devices, have 1"):
        port_mesh.make_mesh(1, 2)
    mesh = port_mesh.make_mesh()
    assert (mesh.num_data, mesh.num_model, mesh.data_group) == (1, 1, None)
    dims = ModelDims.from_config(_port_cfg(_cfg(GQA)))
    port_mesh.check_tensor_parallel(dims, 2)
    with pytest.raises(ValueError, match="4 query heads"):
        port_mesh.check_tensor_parallel(dims, 8)
    with pytest.raises(ValueError, match="2 kv heads"):
        port_mesh.check_tensor_parallel(dims, 4)
    params = params_from_jax(_params(_cfg(GQA)))
    same = port_mesh.gather_params(port_mesh.shard_params(params, mesh), mesh)
    for (_, a), (_, b) in zip(tree_leaves(params), tree_leaves(same)):
        assert torch.equal(a, b)
    specs = port_mesh.param_specs(params, tensor_parallel=True)
    assert specs["encoder"]["self_attn"]["wq"] == -1
    assert specs["decoder"]["ffn"]["w2"] == -2
    assert specs["embed"]["value"] is None
    assert port_mesh.spec_for_path("embed/patch", True) is None
    assert port_mesh.spec_for_path("encoder/ffn/b2", True) is None
    assert port_mesh.spec_for_path("encoder/ffn/w1", False) is None


def test_shard_seed_folds_row_and_head_offsets():
    """A call on rows 2.. and heads 3.. of a larger call draws that call's
    keep bits under `shard_seed`, also where the fold wraps past 2^31."""
    from plankassembly_tpu_torch.ops import flash_train as FT

    for seed in (12345, 2 ** 31 - 2):
        whole = FT.keep_mask(4, 6, 20, 128, 0.2, seed)
        part = FT.keep_mask(2, 3, 20, 128, 0.2, FT.shard_seed(
            torch.tensor([seed], dtype=torch.int32), 2, 3))
        assert torch.equal(part, whole[2:, 3:])
    assert FT.shard_seed(7, 0, 0) == 7
