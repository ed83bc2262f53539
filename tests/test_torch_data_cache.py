"""The port's packed-sample cache and device-resident training data on the
CPU against the JAX package (`plankassembly_tpu_torch/data/cache.py`,
`data/device_loader.py`, `train/state.py::make_device_train_step`, and
`trainer.sample_cache` / `trainer.device_data` in `train/loop.py`)."""
import dataclasses
import gzip
import json
import os

import numpy as np
import pytest
import torch

from plankassembly_tpu.config import load_config as jax_load_config
from plankassembly_tpu.data.device_loader import (
    DeviceDataLoader as JaxDeviceDataLoader,
)
from plankassembly_tpu.data.device_loader import unpack_flat
from plankassembly_tpu.data.line_data import LineDataset as JaxLineDataset
from plankassembly_tpu.data.sideface_data import (
    SidefaceDataset as JaxSidefaceDataset,
)
from plankassembly_tpu_torch.data.device_loader import DeviceDataLoader
from plankassembly_tpu_torch.data.line_data import LineDataset
from plankassembly_tpu_torch.data.loader import DataLoader
from plankassembly_tpu_torch.data.sideface_data import SidefaceDataset
from plankassembly_tpu_torch.train.loop import SidefaceTrainer, Trainer
from tests.test_torch_train_e2e import _port_cfg, make_cfg
from tests.tiny import write_tiny_dataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN64 = os.path.join(ROOT, "plankassembly_tpu_torch", "fixtures",
                       "train64.json.gz")
CLASSES = {"line": (LineDataset, JaxLineDataset),
           "sideface": (SidefaceDataset, JaxSidefaceDataset)}


@pytest.fixture(scope="module")
def info_dir(tmp_path_factory):
    """The first 24 drawings of the training fixture as info JSONs."""
    root = tmp_path_factory.mktemp("cache_data") / "infos"
    os.makedirs(root)
    with gzip.open(TRAIN64) as f:
        infos = json.load(f)[:24]
    for info in infos:
        with open(root / f"{info['name']}.json", "w") as f:
            json.dump(info, f)
    return str(root), [f"{i['name']}.json" for i in infos]


CONFIGS = {"line": "train_synthetic_gqa.yaml",
           "sideface": "train_synthetic_sideface_gqa.yaml"}


def _cfgs(kind, aug_ratio=0.1):
    jcfg = jax_load_config(os.path.join(ROOT, "configs", CONFIGS[kind]))
    jcfg = dataclasses.replace(jcfg, DATA=dataclasses.replace(
        jcfg.DATA, AUG_RATIO=aug_ratio))
    return _port_cfg(jcfg), jcfg


def _rows_equal(a, b):
    assert sorted(a) == sorted(b)
    for key in b:
        if key != "name":
            np.testing.assert_array_equal(np.asarray(a[key]),
                                          np.asarray(b[key]), err_msg=key)


@pytest.mark.parametrize("kind", sorted(CLASSES))
@pytest.mark.parametrize("builder", ["jax", "port"])
def test_cache_is_shared_between_the_packages(info_dir, tmp_path, kind,
                                              builder):
    """A cache one package builds, the other opens (the same digest
    directory, no second build) and reads row for row."""
    root, names = info_dir
    cfg, jcfg = _cfgs(kind)
    ours_cls, jax_cls = CLASSES[kind]
    cache_dir = str(tmp_path / "cache")
    first, second = ((jax_cls, jcfg), (ours_cls, cfg))
    if builder == "port":
        first, second = second, first
    built = first[0](root, names, first[1], cache_dir=cache_dir)
    digests = os.listdir(cache_dir)
    assert len(digests) == 1
    opened = second[0](root, names, second[1], cache_dir=cache_dir)
    assert os.listdir(cache_dir) == digests
    assert opened._cache.meta == built._cache.meta
    for i in range(len(names)):
        _rows_equal(opened._cache.row(i), built._cache.row(i))
        _rows_equal(opened[i], built[i])
        assert opened[i]["name"] == built[i]["name"]


@pytest.mark.parametrize("kind", sorted(CLASSES))
def test_cached_dataset_returns_the_uncached_rows(info_dir, tmp_path, kind):
    root, names = info_dir
    cfg, _ = _cfgs(kind)
    cls = CLASSES[kind][0]
    plain = cls(root, names, cfg)
    cached = cls(root, names, cfg, cache_dir=str(tmp_path / "c"))
    assert plain._cache is None and cached._cache is not None
    for i in range(len(names)):
        a, b = cached[i], plain[i]
        _rows_equal(a, b)
        assert a["name"] == b["name"]


@pytest.mark.parametrize("kind", sorted(CLASSES))
@pytest.mark.parametrize("aug_ratio", [0.0, 0.5])
def test_device_loader_matches_jax(info_dir, tmp_path, aug_ratio, kind):
    """Two epochs of the port's DeviceDataLoader on the CPU against the
    JAX loader's `materialize` for the same seed: the same rows in the
    same order, the same augmented positions, and the same batches (clean
    rows and, under equal dataset RandomStates, augmented rows). The JAX
    loader cannot pack an augmented sideface row (its dataset's `_pack`
    has another signature), so there the port is held to its own dataset
    read with the same draws."""
    root, names = info_dir
    cfg, jcfg = _cfgs(kind, aug_ratio)
    ours_cls, jax_cls = CLASSES[kind]
    cache_dir = str(tmp_path / "cache")
    ds = ours_cls(root, names, cfg, augmentation=True,
                  rng=np.random.RandomState(5), cache_dir=cache_dir)
    jds = jax_cls(root, names, jcfg, augmentation=True,
                  rng=np.random.RandomState(5), cache_dir=cache_dir)
    B, K = 8, 3
    ours = DeviceDataLoader(ds, ds._cache, B, "cpu", seed=11, max_aug_rows=K)
    ref = JaxDeviceDataLoader(jds, jds._cache, B, seed=11, max_aug_rows=K)
    assert len(ours) == len(ref) == len(names) // B
    twin = ours_cls(root, names, cfg, augmentation=True,
                    rng=np.random.RandomState(5), cache_dir=cache_dir)
    emulate = kind == "sideface" and aug_ratio > 0
    order_rng = np.random.default_rng(11)  # the JAX loader's draws
    augmented = 0
    for _ in range(2):
        if emulate:
            order = order_rng.permutation(len(names))
        else:
            jbatches = list(ref)
        for n, batch in enumerate(ours):
            got = ours.materialize(batch)
            assert got["input_value"].dtype == torch.int64
            if emulate:
                idx = order[n * B:(n + 1) * B]
                pos = np.flatnonzero(order_rng.random(B) < aug_ratio)[:K]
                want = {k: np.stack([twin._cache.row(int(i))[k]
                                     for i in idx])
                        for k in twin._cache.fields}
                for j in pos:
                    _, arrays = twin._pack(int(idx[j]), True, twin.rng)
                    for k in want:
                        want[k][j] = arrays[k]
                want["name"] = [ours.names[i] for i in idx]
            else:
                jb = jbatches[n]
                _, jpos, _ = unpack_flat(jb["_buf"], ref.layout, B, K)
                jpos = np.asarray(jpos)
                pos = jpos[jpos < B]
                want = ref.materialize(jb)
            assert got["name"] == want["name"]
            np.testing.assert_array_equal(batch["pos"].numpy(), pos)
            augmented += len(pos)
            _rows_equal(got, {k: v if k == "name" else np.asarray(v)
                              for k, v in want.items()})
    assert (augmented > 0) == (aug_ratio > 0)


def test_jax_device_loader_cannot_pack_an_augmented_sideface_row(info_dir,
                                                                tmp_path):
    """The reference fault the port's loop docstring names: the JAX
    device loader raises on the first augmented sideface row."""
    root, names = info_dir
    _, jcfg = _cfgs("sideface", 1.0)
    jds = JaxSidefaceDataset(root, names, jcfg, augmentation=True,
                             cache_dir=str(tmp_path / "cache"))
    with pytest.raises(TypeError, match="augment"):
        list(JaxDeviceDataLoader(jds, jds._cache, 8, seed=0))


def _jax_cfg(cfg):
    """The JAX package's Config with the port Config's values."""
    from plankassembly_tpu import config as jc
    d = dataclasses.asdict(cfg)
    return jc.Config(**{**d, "trainer": jc.TrainerConfig(**d["trainer"]),
                        "DATA": jc.DataConfig(**d["DATA"]),
                        "MODEL": jc.ModelConfig(**d["MODEL"]),
                        "TOKEN": jc.TokenConfig(**d["TOKEN"])})


@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiny")
    write_tiny_dataset(str(root), n_samples=8)
    return root


@pytest.mark.parametrize("flags", [(False, False), (True, False),
                                   (False, True), (True, True)],
                         ids=["plain", "sample_cache", "device_data",
                              "both"])
def test_data_flags_pick_the_loader_jax_picks(tiny_dir, tmp_path, flags):
    """`trainer.sample_cache` gives the dataset a packed-sample cache under
    <default_root_dir>/.sample_cache, `trainer.device_data` the device
    loader over it, in the port's trainers as in JAX's."""
    from plankassembly_tpu.train import SidefaceTrainer as JaxSideface
    from plankassembly_tpu.train import Trainer as JaxTrainer
    sample_cache, device_data = flags
    cfg = make_cfg(tiny_dir, tmp_path / "logs", sample_cache=sample_cache,
                   device_data=device_data)
    jcfg = _jax_cfg(cfg)
    for ours_cls, jax_cls in ((Trainer, JaxTrainer),
                              (SidefaceTrainer, JaxSideface)):
        trainer = ours_cls(cfg, device="cpu")
        loader = trainer.train_dataloader()
        jloader = jax_cls(jcfg).train_dataloader()
        assert type(loader).__name__ == type(jloader).__name__
        kind = DeviceDataLoader if device_data else DataLoader
        assert isinstance(loader, kind)
        has_cache = loader.dataset._cache is not None
        assert has_cache == (jloader.dataset._cache is not None) == (
            sample_cache or device_data)
        if has_cache:
            assert os.path.isdir(os.path.join(
                cfg.trainer.default_root_dir, ".sample_cache"))
        loader.close()
        trainer.close()


def test_device_data_losses_equal_the_plain_step(tiny_dir, tmp_path):
    """A tiny fit with `trainer.device_data` (dropout and augmentation on)
    takes the device loader, and its losses equal those of the same
    batches fed through the plain step from the same start."""
    from plankassembly_tpu_torch.data.device_loader import (
        DeviceDataLoader as Loader,
    )
    cfg = make_cfg(tiny_dir, tmp_path / "logs", device_data=True,
                   max_epochs=3, check_val_every_n_epoch=100,
                   save_last=False)
    cfg = dataclasses.replace(cfg, BATCH_SIZE=2)
    trainer = Trainer(cfg, compute_dtype=torch.float32, device="cpu")
    state = trainer.fit()
    assert state.step == 3 * 4
    with open(os.path.join(trainer.log_dir, "metrics.jsonl")) as f:
        losses = [r["train/loss"] for r in map(json.loads, f)
                  if "train/loss" in r]
    trainer.close()

    twin = Trainer(cfg, compute_dtype=torch.float32, device="cpu")
    loader = twin.train_dataloader()
    assert isinstance(loader, Loader)
    tstate = twin.init_state()
    plain, augmented = [], 0
    for _ in range(3):
        for batch in loader:
            augmented += batch["pos"].numel()
            arrays = {k: v for k, v in loader.materialize(batch).items()
                      if k != "name"}
            plain.append(float(twin.train_step_fn(tstate, arrays,
                                                  twin._rng)["loss"]))
    twin.close()
    assert augmented > 0
    assert len(losses) == len(plain) == 12
    assert losses == plain
