"""The port's trainer end to end on the CPU (mirroring
`tests/test_train_e2e.py`): fit -> checkpoint round trip -> test JSON
dump -> the offline evaluator -> serving the trained checkpoint; the CLI's
surface; and the port's import boundary for the training modules."""
import dataclasses
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from plankassembly_tpu_torch import cli
from plankassembly_tpu_torch.checkpoint import load_checkpoint
from plankassembly_tpu_torch.config import Config
from plankassembly_tpu_torch.train.loop import Trainer
from plankassembly_tpu_torch.train.state import tree_leaves
from tests.tiny import tiny_config, write_tiny_dataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    write_tiny_dataset(str(root))
    return root


def _port_cfg(jax_cfg) -> Config:
    """The port's Config with the JAX Config's values."""
    from plankassembly_tpu_torch.config import (
        DataConfig, ModelConfig, TokenConfig, TrainerConfig,
    )
    d = dataclasses.asdict(jax_cfg)
    return Config(**{**d, "trainer": TrainerConfig(**d["trainer"]),
                     "DATA": DataConfig(**d["DATA"]),
                     "MODEL": ModelConfig(**d["MODEL"]),
                     "TOKEN": TokenConfig(**d["TOKEN"])})


def make_cfg(root, log_root, **trainer):
    cfg = tiny_config()
    cfg = dataclasses.replace(
        cfg, ROOT=str(root / "infos"),
        DATASETS_TRAIN=str(root / "train.txt"),
        DATASETS_VALID=str(root / "valid.txt"),
        DATASETS_TEST=str(root / "test.txt"),
        BATCH_SIZE=4, LR=3e-3,
        DATA=dataclasses.replace(cfg.DATA, MAX_INPUT_LENGTH=320,
                                 MAX_OUTPUT_LENGTH=48, AUG_RATIO=0.5),
        MODEL=dataclasses.replace(cfg.MODEL, NUM_KV_HEAD=1, DROPOUT=0.1),
        trainer=dataclasses.replace(cfg.trainer, **{
            "devices": 1, "max_epochs": 2, "check_val_every_n_epoch": 2,
            "log_every_n_steps": 1, "default_root_dir": str(log_root),
            "decode_impl": "persistent", **trainer}))
    return _port_cfg(cfg)


def test_fit_checkpoint_test_and_serve(dataset_dir, tmp_path):
    cfg = make_cfg(dataset_dir, tmp_path / "logs")
    trainer = Trainer(cfg, compute_dtype=torch.float32, device="cpu")
    init = {k: t.detach().clone() for k, t in
            ((("/".join(p)), t) for p, t in
             tree_leaves(trainer.init_state().params))}
    state = trainer.fit(max_epochs=2)
    assert state.step == 2  # 4 drawings / batch 4 = 1 step per epoch
    moved = [k for k, t in tree_leaves(state.params)
             if not torch.equal(t.detach(), init["/".join(k)])]
    assert len(moved) > 40

    ckpt_dir = os.path.join(trainer.log_dir, "checkpoints")
    for tag in ("best", "last"):
        assert os.path.exists(os.path.join(ckpt_dir, f"{tag}.pt"))
        with open(os.path.join(ckpt_dir, f"{tag}.meta.json")) as f:
            meta = json.load(f)
        assert meta["step"] == 2 and meta["epoch"] == 1
    assert "val/fmeasure" in meta["metrics"] or tag == "last"

    # the round trip is exact: params, Adam moments and the step
    restored = trainer.load_checkpoint(os.path.join(ckpt_dir, "last"))
    assert restored.step == 2
    for (p, a), (_, b) in zip(tree_leaves(state.params),
                              tree_leaves(restored.params)):
        assert torch.equal(a.detach(), b.detach()), p
    sa = state.optimizer.state_dict()["state"]
    sb = restored.optimizer.state_dict()["state"]
    assert sorted(sa) == sorted(sb)
    for i in sa:
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(torch.as_tensor(sa[i][key]),
                               torch.as_tensor(sb[i][key]))

    # the metrics stream
    with open(os.path.join(trainer.log_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    losses = [r["train/loss"] for r in recs if "train/loss" in r]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert any("val/fmeasure" in r for r in recs)

    # test dump: the reference's prediction JSONs
    prec, rec, f1 = trainer.test(state)
    assert 0.0 <= f1 <= 1.0
    pred_dir = os.path.join(trainer.log_dir, "pred_jsons")
    files = sorted(os.listdir(pred_dir))
    assert len(files) == 4
    with open(os.path.join(pred_dir, files[0])) as f:
        payload = json.load(f)
    for key in ("prediction", "attach", "groundtruth", "precision",
                "recall", "fmeasure"):
        assert key in payload

    # the JAX package's offline evaluator reads the dump
    data_path = tmp_path / "evalroot"
    os.makedirs(data_path)
    os.symlink(dataset_dir / "infos", data_path / "infos")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "evaluate.py"), "--data_path",
         str(data_path), "--exp_path", trainer.log_dir],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    assert "f1" in out.stdout

    # a checkpoint the port trained serves through make_live_backend
    from plankassembly_tpu_torch.serving import (
        make_live_backend, pack_info_dict,
    )
    params, scfg = load_checkpoint(os.path.join(ckpt_dir, "best.pt"),
                                   device="cpu")
    assert scfg == cfg
    backend, meta = make_live_backend(params, scfg, batch=2, bucket=384,
                                      compute_dtype=torch.float32,
                                      device="cpu")
    with open(dataset_dir / "infos" / "syn000.json") as f:
        packed = pack_info_dict(json.load(f), scfg)
    res = backend({k: v[None] for k, v in packed.items()})
    assert res["samples"].shape == (1, cfg.DATA.MAX_OUTPUT_LENGTH)


def test_fit_from_released_npz_and_guards(dataset_dir, tmp_path):
    """A released .npz starts a fit with a fresh Adam state; multi-device
    settings and unknown decode options raise instead of running."""
    cfg = make_cfg(dataset_dir, tmp_path / "logs")
    trainer = Trainer(cfg, compute_dtype=torch.float32, device="cpu")
    path = tmp_path / "tiny.npz"
    flat = {"/".join(p): t.detach().numpy()
            for p, t in tree_leaves(trainer.init_state(seed=9).params)}
    np.savez(path, **flat)
    state = trainer.load_checkpoint(str(path))
    assert state.step == 0 and not state.optimizer.state_dict()["state"]
    np.testing.assert_array_equal(
        state.params["heads"]["vocab"]["w"].detach().numpy(),
        flat["heads/vocab/w"])
    for bad, match in ((dict(devices=2), "Parallel"),
                       (dict(strategy="dp+tp"), "Parallel")):
        with pytest.raises(NotImplementedError, match=match):
            Trainer(make_cfg(dataset_dir, tmp_path / "l2", **bad),
                    device="cpu")
    # every decode_impl of the JAX trainer is taken; an unknown one raises
    for impl, beams in (("auto", 0), ("beam4", 4)):
        tr = Trainer(make_cfg(dataset_dir, tmp_path / "l2",
                              decode_impl=impl), device="cpu")
        assert tr.num_beams == beams
    with pytest.raises(ValueError, match="decode_impl"):
        Trainer(make_cfg(dataset_dir, tmp_path / "l2", decode_impl="beam"),
                device="cpu")


def _write_yaml(path, root, log_root):
    path.write_text(f"""seed_everything: 7
trainer:
  max_epochs: 5
  check_val_every_n_epoch: 1
  log_every_n_steps: 1
  default_root_dir: {log_root}
  decode_impl: persistent
model:
  hparams:
    ROOT: {root / 'infos'}
    DATASETS_TRAIN: {root / 'train.txt'}
    DATASETS_VALID: {root / 'valid.txt'}
    DATASETS_TEST: {root / 'test.txt'}
    BATCH_SIZE: 4
    NUM_WORKERS: 2
    LR: 1e-3
    DATA:
      MAX_INPUT_LENGTH: 320
      MAX_OUTPUT_LENGTH: 48
    MODEL:
      NUM_MODEL: 16
      NUM_HEAD: 2
      NUM_KV_HEAD: 1
      NUM_FEEDFORWARD: 32
      NUM_ENCODER_LAYERS: 1
      NUM_DECODER_LAYERS: 1
""")


def test_cli_surface(dataset_dir, tmp_path, monkeypatch):
    cfg_path = tmp_path / "tiny.yaml"
    _write_yaml(cfg_path, dataset_dir, tmp_path / "runs")
    sub, conf, ckpt, dev, over = cli.parse_args(
        ["test", "--config", "c.yaml", "--ckpt_path", "x", "--device", "cpu",
         "--model.hparams.LR", "2e-5", "--trainer.max_epochs", "3"])
    assert (sub, conf, ckpt, dev) == ("test", "c.yaml", "x", "cpu")
    assert over == {"model.hparams.LR": "2e-5", "trainer.max_epochs": "3"}
    for argv in (["train", "--config", "c"], ["fit"], ["test", "--config",
                                                       "c"],
                 ["fit", "--config"], ["fit", "stray"]):
        with pytest.raises(SystemExit):
            cli.parse_args(argv)

    # fit and validate through main(), on the CPU, with an override
    trainer, state = cli.main(["fit", "--config", str(cfg_path), "--device",
                               "cpu", "--trainer.max_epochs", "1"])
    assert state.step == 1
    assert trainer.cfg.trainer.max_epochs == 1
    assert trainer.cfg.LR == 1e-3 and trainer.device.type == "cpu"
    last = os.path.join(trainer.log_dir, "checkpoints", "last")
    _, scores = cli.main(["validate", "--config", str(cfg_path),
                          "--ckpt_path", last, "--device", "cpu"])
    assert len(scores) == 3 and all(0.0 <= s <= 1.0 for s in scores)

    # the default device is CUDA, and without it the CLI raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["fit", "--config", str(cfg_path)])


_ISOLATED = r"""
import sys
for name in ("jax", "jaxlib", "yaml", "ml_dtypes", "optax", "orbax",
             "plankassembly_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError
import plankassembly_tpu_torch.cli
import plankassembly_tpu_torch.train.loop
import plankassembly_tpu_torch.train.state
import plankassembly_tpu_torch.ops.flash_train
import plankassembly_tpu_torch.data.loader
import plankassembly_tpu_torch.data.line_data
import plankassembly_tpu_torch.data.noise
import plankassembly_tpu_torch.utils.profiling
from plankassembly_tpu_torch.config import load_config
cfg = load_config(sys.argv[1])
leaked = sorted(m for m in sys.modules if sys.modules[m] is not None and (
    m.split(".")[0] in ("jax", "jaxlib", "yaml", "ml_dtypes", "optax",
                        "orbax")
    or m == "plankassembly_tpu" or m.startswith("plankassembly_tpu.")))
print("LEAKED", leaked)
print("KV", cfg.MODEL.NUM_KV_HEAD)
"""


def test_training_modules_import_without_jax_yaml_optax_or_orbax():
    out = subprocess.run(
        [sys.executable, "-c", _ISOLATED,
         os.path.join(ROOT, "configs", "train_synthetic_gqa.yaml")],
        capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "LEAKED []" in out.stdout, out.stdout
    assert "KV 2" in out.stdout


def test_no_banned_import_lines():
    """No import line of jax, the JAX package, yaml, optax or orbax in the
    port, `chip_smoke.py` or the training profiler."""
    banned = re.compile(r"^\s*(import|from)\s+(jax|plankassembly_tpu(\.|\s)"
                        r"|yaml|optax|orbax)")
    files = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "tools", "profile_torch_train.py")]
    for base, _, names in os.walk(os.path.join(ROOT,
                                               "plankassembly_tpu_torch")):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for path in files:
        with open(path) as f:
            for lineno, line in enumerate(f, 1):
                assert not banned.match(line), f"{path}:{lineno}: {line}"
