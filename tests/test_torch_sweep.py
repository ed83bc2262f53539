"""The port's evaluation tools on a tiny model and dataset, against the
JAX package's: `tools/robustness_sweep.py` (every variant's test run
against JAX's `Trainer.test` in float32, prediction JSONs and scores) and
`tools/build_{gt,pred}_mesh.py` / `tools/build_html.py` (the same files as
the JAX tools write)."""
import argparse
import dataclasses
import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plankassembly_tpu.config import load_config as jax_load_config
from plankassembly_tpu.models.model import (
    ModelDims as JaxDims, init_params as jax_init,
)
from plankassembly_tpu.train import Trainer as JaxTrainer
from plankassembly_tpu.train.state import TrainState as JaxState
from plankassembly_tpu_torch import evaluate
from plankassembly_tpu_torch.checkpoint import params_from_jax
from plankassembly_tpu_torch.config import load_config
from plankassembly_tpu_torch.tools import (
    build_gt_mesh, build_html, build_pred_mesh, generate_models,
    prepare_info, render_svgs, robustness_sweep,
)
from plankassembly_tpu_torch.train.loop import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
VARIANTS = ("complete", "noise_05", "noise_10")

CONFIG = """seed_everything: 7
trainer:
  devices: 1
  max_epochs: 1
  default_root_dir: {root}/runs
model:
  hparams:
    ROOT: {root}/data/complete/infos
    DATASETS_TRAIN: {root}/splits/train.txt
    DATASETS_VALID: {root}/splits/valid.txt
    DATASETS_TEST: {root}/splits/test.txt
    BATCH_SIZE: 4
    NUM_WORKERS: 0
    DATA:
      MAX_INPUT_LENGTH: 1200
      MAX_OUTPUT_LENGTH: 128
    MODEL:
      NUM_MODEL: 16
      NUM_HEAD: 2
      NUM_KV_HEAD: 1
      NUM_FEEDFORWARD: 32
      DROPOUT: 0.0
      NUM_ENCODER_LAYERS: 1
      NUM_DECODER_LAYERS: 1
"""


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    """A 5-drawing test-only dataset of the three variants (the port's
    tools), a tiny random checkpoint of the port, the port's sweep in f32
    on the CPU and JAX's Trainer.test of each variant."""
    tmp = tmp_path_factory.mktemp("sweep")
    root = str(tmp / "data")
    generate_models.main(["--root", root, "--count", "5", "--seed", "31000",
                          "--test_frac", "1.0"])
    for variant in VARIANTS:
        render_svgs.main(["--root", root, "--data_type", variant,
                          "--max_workers", "1"])
        prepare_info.main(["--data_path", root, "--data_type", variant,
                           "--max_workers", "1"])
    config = str(tmp / "tiny.yaml")
    with open(config, "w") as f:
        f.write(CONFIG.format(root=root))

    jcfg = jax_load_config(config, {"trainer.decode_impl": "xla"})
    jparams = jax_init(jax.random.PRNGKey(21), JaxDims.from_config(jcfg))
    trainer = Trainer(load_config(config), log_dir=str(tmp / "run"),
                      compute_dtype=torch.float32, device="cpu")
    state = trainer._state(params_from_jax(jax.tree.map(np.asarray,
                                                        jparams)))
    ckpt = trainer.save_checkpoint(state, "last")
    trainer.close()

    out_dir = str(tmp / "out")
    results = robustness_sweep.main([
        "--config", config, "--ckpt_path", ckpt, "--data_root", root,
        "--precision", "f32", "--device", "cpu", "--out_dir", out_dir,
        "--trainer.decode_impl", "xla"])
    ref = {}
    for variant in VARIANTS:
        cfg = dataclasses.replace(jcfg, ROOT=os.path.join(
            root, "data", variant, "infos"))
        jt = JaxTrainer(cfg, log_dir=str(tmp / "jax" / variant),
                        compute_dtype=jnp.float32)
        ref[variant] = jt.test(JaxState(jparams, None, jnp.int32(0)))
    return {"root": root, "out": out_dir, "tmp": tmp, "results": results,
            "ref": ref}


def _preds(run_dir):
    pred_dir = os.path.join(run_dir, "pred_jsons")
    out = {}
    for name in sorted(os.listdir(pred_dir)):
        with open(os.path.join(pred_dir, name)) as f:
            out[name] = json.load(f)
    return out


def test_sweep_equals_jax_trainer_test(sweep):
    with open(os.path.join(sweep["out"], "sweep.json")) as f:
        written = json.load(f)
    assert written == sweep["results"]
    assert sorted(written) == sorted(VARIANTS)
    for variant in VARIANTS:
        got = sweep["results"][variant]
        prec, rec, f1 = sweep["ref"][variant]
        np.testing.assert_allclose(
            [got["precision"], got["recall"], got["fmeasure"]],
            [prec, rec, f1], atol=1e-9)
        ours = _preds(os.path.join(sweep["out"], f"sweep_{variant}"))
        ref = _preds(os.path.join(sweep["tmp"], "jax", variant))
        assert sorted(ours) == sorted(ref) and len(ours) == 5
        assert ours == ref, variant
    # the noisy variants lost lines: their drawings are not the clean ones
    with open(os.path.join(sweep["root"], "data", "noise_10", "infos",
                           "syn031000.json")) as f, \
            open(os.path.join(sweep["root"], "data", "complete", "infos",
                              "syn031000.json")) as g:
        assert json.load(f)["lines"] != json.load(g)["lines"]


def test_sweep_arguments():
    args, overrides = robustness_sweep.parse_args(
        ["--config", "c.yaml", "--ckpt_path", "x.npz",
         "--trainer.kv_quant", "true", "--trainer.decode_impl", "persistent"])
    assert args.variants == list(VARIANTS) and args.precision == "bf16"
    assert overrides == {"trainer.kv_quant": "true",
                         "trainer.decode_impl": "persistent"}
    with pytest.raises(SystemExit):
        robustness_sweep.parse_args(["--config", "c", "--ckpt_path", "x",
                                     "--trainer.kv_quant"])


def _files(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def test_mesh_and_gallery_tools_equal_jax(sweep, tmp_path):
    """build_pred_mesh, build_gt_mesh and build_html on the sweep's test
    run write the JAX tools' files (the gallery's shuffle seeded alike)."""
    import build_gt_mesh as jax_gt
    import build_html as jax_html
    import build_pred_mesh as jax_pred

    run = os.path.join(sweep["out"], "sweep_complete")
    evaluate.main(evaluate.parse_args(
        ["--data_path", os.path.join(sweep["root"], "data", "complete"),
         "--exp_path", run]))
    exps, datas = {}, {}
    for who in ("port", "jax"):
        exps[who] = str(tmp_path / who / "exp")
        shutil.copytree(run, exps[who])
        datas[who] = str(tmp_path / who / "data")
        os.makedirs(datas[who])
        for part in ("splits", "data"):
            shutil.copytree(os.path.join(sweep["root"], part),
                            os.path.join(datas[who], part))

    assert build_pred_mesh.main(["--exp_path", exps["port"]]) == 5
    assert build_gt_mesh.main(["--data_path", datas["port"]]) == 5
    np.random.seed(0)
    assert build_html.main(["--data_path", datas["port"],
                            "--exp_path", exps["port"]]) == 5

    os.makedirs(os.path.join(exps["jax"], "pred_meshes"))
    jax_pred.main(argparse.Namespace(exp_path=exps["jax"]))
    os.makedirs(os.path.join(datas["jax"], "mesh"))
    jax_gt.main(argparse.Namespace(data_path=datas["jax"]))
    for folder in ("pred_mesh", "gt_mesh"):
        os.makedirs(os.path.join(exps["jax"], folder))
    np.random.seed(0)
    jax_html.main(argparse.Namespace(data_path=datas["jax"],
                                     exp_path=exps["jax"]))

    ours, ref = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert sorted(ours) == sorted(ref)
    assert sum(k.endswith(".stl") for k in ours) == 10
    assert sum(k.endswith(".glb") for k in ours) == 10
    for key in ref:
        assert ours[key] == ref[key], key
    page = ours[os.path.join("exp", "index.html")].decode()
    assert all(f"<td>syn03100{i}</td>" in page for i in range(5))
