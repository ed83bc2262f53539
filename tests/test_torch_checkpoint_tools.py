"""The port's checkpoint tools against the JAX package's:
`tools/convert_reference_checkpoint.py` (the reference's Lightning layout
-> the port's training checkpoint) against `tools/convert_torch_checkpoint.py`,
and `tools/export_checkpoint.py` (training checkpoint <-> released npz)
round trips across both packages."""
import argparse
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plankassembly_tpu.models.model import (
    ModelDims as JaxDims, init_params as jax_init, train_step_loss as jax_loss,
)
from plankassembly_tpu_torch.checkpoint import (
    load_checkpoint, load_npz, params_from_jax,
)
from plankassembly_tpu_torch.config import ModelDims, write_hparams_yaml
from plankassembly_tpu_torch.models.model import train_step_loss
from plankassembly_tpu_torch.tools import (
    convert_reference_checkpoint as conv, export_checkpoint as export,
)
from plankassembly_tpu_torch.train.loop import Trainer
from plankassembly_tpu_torch.train.state import tree_leaves
from tests.test_torch_train_e2e import _port_cfg
from tests.tiny import random_batch, tiny_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

CFG = tiny_config()
JDIMS = JaxDims.from_config(CFG)


def _flat(tree):
    return {"/".join(p): np.asarray(t.detach().float()) for p, t in
            tree_leaves(tree)}


def _jax_flat(tree):
    return {"/".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _bf16(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def reference_layout(params):
    """The reference's state dict of JAX parameters, built through the
    torch parity modules as `tests/test_converter.py` builds it."""
    from tests.test_converter import build_torch_decoder, build_torch_encoder
    sd = {}
    for key, val in build_torch_encoder(params).state_dict().items():
        sd[f"model.encoder.{key}"] = val.numpy()
    for key, val in build_torch_decoder(params).state_dict().items():
        sd[f"model.decoder.{key}"] = val.numpy()
    emb, hp = params["embed"], params["heads"]
    for name, key in (("input_embeddings.input_value", "value"),
                      ("input_embeddings.input_pos", "pos_in"),
                      ("input_embeddings.input_coord", "coord_in"),
                      ("input_embeddings.input_view", "view"),
                      ("input_embeddings.input_type", "type"),
                      ("query_coord_embedding", "coord_out"),
                      ("query_pos_embedding", "pos_out")):
        sd[f"model.{name}.weight"] = np.asarray(emb[key])
    for name in ("vocab", "pointer", "switch"):
        sd[f"model.{name}_head.weight"] = np.asarray(hp[name]["w"]).T
        sd[f"model.{name}_head.bias"] = np.asarray(hp[name]["b"])
    return sd


@pytest.fixture(scope="module")
def jax_params():
    return jax_init(jax.random.PRNGKey(3), JDIMS)


def test_convert_state_dict_equals_jax(jax_params):
    from convert_torch_checkpoint import convert_state_dict as jax_convert
    sd = reference_layout(jax_params)
    ours = conv.convert_state_dict(sd, 1, 1)
    ref = jax_convert(sd, 1, 1)
    flat_ours = {"/".join(k.key for k in p): v for p, v in
                 jax.tree_util.tree_leaves_with_path(ours)}
    flat_ref = _jax_flat(ref)
    assert sorted(flat_ours) == sorted(flat_ref) == sorted(_jax_flat(jax_params))
    for key in flat_ref:
        np.testing.assert_array_equal(flat_ours[key], flat_ref[key])
        assert flat_ours[key].dtype == np.float32
    # the inverse mapping rebuilds the reference's state dict exactly
    back = conv.reference_state_dict(params_from_jax(jax.tree.map(
        np.asarray, jax_params)))
    assert sorted(back) == sorted(sd)
    for key in sd:
        np.testing.assert_array_equal(back[key].numpy(), sd[key])


def test_converted_checkpoint_trains_and_serves_as_jax(jax_params, tmp_path):
    """`main` on a Lightning-style `.ckpt`: the port's training checkpoint
    loads with `Trainer.load_checkpoint` and `load_checkpoint`, and gives
    JAX's f32 loss on the original parameters."""
    ckpt = tmp_path / "ref.ckpt"
    sd = reference_layout(jax_params)
    torch.save({"epoch": 3, "state_dict": {k: torch.from_numpy(v.copy())
                                           for k, v in sd.items()}}, ckpt)
    cfg = _port_cfg(dataclasses.replace(CFG, trainer=dataclasses.replace(
        CFG.trainer, default_root_dir=str(tmp_path / "logs"))))
    hp = tmp_path / "tiny.hparams.yaml"
    write_hparams_yaml(cfg, str(hp))
    out = conv.main(["--ckpt", str(ckpt), "--out",
                     str(tmp_path / "run" / "checkpoints" / "reference"),
                     "--encoder_layers", "1", "--decoder_layers", "1",
                     "--hparams", str(hp)])
    assert out.endswith("reference.pt")
    assert os.path.exists(tmp_path / "run" / "hparams.yaml")

    trainer = Trainer(cfg, log_dir=str(tmp_path / "t"),
                      compute_dtype=torch.float32, device="cpu")
    state = trainer.load_checkpoint(out)
    trainer.close()
    assert state.step == 0
    ref = _jax_flat(jax_params)
    got = _flat(state.params)
    assert sorted(got) == sorted(ref)
    for key in ref:
        np.testing.assert_array_equal(got[key], ref[key])
    params, served_cfg = load_checkpoint(out, device="cpu")
    assert ModelDims.from_config(served_cfg) == ModelDims.from_config(cfg)

    batch = random_batch(CFG, batch_size=3, seed=5)
    ref_loss, _ = jax_loss(jax_params, {k: jnp.asarray(v) for k, v in
                                        batch.items()}, JDIMS,
                           deterministic=True, compute_dtype=jnp.float32)
    loss, _ = train_step_loss(
        params, {k: torch.from_numpy(v) for k, v in batch.items()},
        ModelDims.from_config(cfg), deterministic=True,
        compute_dtype=torch.float32)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-6)


def test_reference_layout_refuses_grouped_query_attention():
    gqa = dataclasses.replace(CFG, MODEL=dataclasses.replace(
        CFG.MODEL, NUM_KV_HEAD=1))
    params = jax_init(jax.random.PRNGKey(0), JaxDims.from_config(gqa))
    with pytest.raises(ValueError, match="grouped-query"):
        conv.reference_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                               params)))


def _port_training_checkpoint(jax_params, run_dir, step=7):
    """A training checkpoint of the port holding `jax_params`."""
    cfg = _port_cfg(CFG)
    trainer = Trainer(cfg, log_dir=str(run_dir), compute_dtype=torch.float32,
                      device="cpu")
    state = trainer._state(params_from_jax(jax.tree.map(np.asarray,
                                                        jax_params)))
    state.step = step
    path = trainer.save_checkpoint(state, "best", epoch=2,
                                   metrics={"val/fmeasure": 0.5})
    trainer.close()
    return path


def test_port_npz_imports_in_jax(jax_params, tmp_path):
    """port .pt -> port export -> JAX import: bf16 parameters, the step,
    the hparams and meta copies."""
    import orbax.checkpoint as ocp

    from export_checkpoint import do_import as jax_import
    pt = _port_training_checkpoint(jax_params, tmp_path / "run")
    npz = tmp_path / "rel" / "tiny.npz"
    export.main(["export", "--ckpt", pt, "--out", str(npz)])
    assert (tmp_path / "rel" / "tiny.hparams.yaml").exists()
    assert (tmp_path / "rel" / "tiny.meta.json").exists()
    with np.load(npz) as z:
        assert int(z["__step__"]) == 7
        assert all(z[k].dtype == np.dtype("V2") for k in z.files
                   if k != "__step__")
    out = tmp_path / "orbax"
    jax_import(argparse.Namespace(npz=str(npz), out=str(out), lr=1e-4))
    with ocp.StandardCheckpointer() as ckptr:
        back = ckptr.restore(str(out))
    assert int(np.asarray(back["step"])) == 7
    got = _jax_flat(back["params"])
    ref = _jax_flat(jax_params)
    assert sorted(got) == sorted(ref)
    for key in ref:
        np.testing.assert_array_equal(got[key], _bf16(ref[key]))


def test_jax_npz_imports_in_the_port(jax_params, tmp_path):
    """JAX export -> port import -> Trainer.load_checkpoint, and the port's
    export of that checkpoint writes JAX's arrays bit for bit."""
    import orbax.checkpoint as ocp

    from export_checkpoint import do_export as jax_export
    from plankassembly_tpu.train.state import init_state, make_optimizer
    state = init_state(jax_params, make_optimizer(1e-4))
    ckpt = tmp_path / "jrun" / "checkpoints" / "best"
    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save(str(ckpt), {"params": state.params,
                               "opt_state": state.opt_state, "step": 9})
    jnpz = tmp_path / "jax.npz"
    jax_export(argparse.Namespace(ckpt=str(ckpt), out=str(jnpz)))

    pt = tmp_path / "prun" / "checkpoints" / "imported.pt"
    export.main(["import", "--npz", str(jnpz), "--out", str(pt)])
    trainer = Trainer(_port_cfg(CFG), log_dir=str(tmp_path / "t"),
                      compute_dtype=torch.float32, device="cpu")
    loaded = trainer.load_checkpoint(str(pt))
    trainer.close()
    assert loaded.step == 9
    assert loaded.optimizer.state_dict()["state"] == {}  # fresh Adam
    ref = _jax_flat(jax_params)
    got = _flat(loaded.params)
    for key in ref:
        np.testing.assert_array_equal(got[key], _bf16(ref[key]))

    pnpz = tmp_path / "port.npz"
    export.main(["export", "--ckpt", str(pt), "--out", str(pnpz)])
    with np.load(jnpz) as a, np.load(pnpz) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype
            assert a[key].tobytes() == b[key].tobytes(), key
    # and the serving loader reads it as it reads the released npz
    flat = _flat(load_npz(str(pnpz)))
    for key in ref:
        np.testing.assert_array_equal(flat[key], _bf16(ref[key]))
