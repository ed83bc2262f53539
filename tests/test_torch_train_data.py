"""The port's training configuration and data pipeline against the JAX
package: `load_config` on every config, geometry, `add_noise`,
`LineDataset` on the training fixture's drawings (with and without
augmentation) and the `DataLoader` order."""
import dataclasses
import glob
import gzip
import json
import os

import numpy as np
import pytest

from plankassembly_tpu.config import load_config as jax_load_config
from plankassembly_tpu.data import geometry as jgeo
from plankassembly_tpu.data.line_data import LineDataset as JaxLineDataset
from plankassembly_tpu.data.loader import DataLoader as JaxDataLoader
from plankassembly_tpu.data.loader import pad_batch_to as jax_pad_batch_to
from plankassembly_tpu.data.noise import add_noise as jax_add_noise
from plankassembly_tpu_torch.config import (
    config_from_hparams_file, load_config, read_hparams_yaml,
    write_hparams_yaml,
)
from plankassembly_tpu_torch.data import geometry as geo
from plankassembly_tpu_torch.data.line_data import LineDataset
from plankassembly_tpu_torch.data.loader import (
    DataLoader, pad_batch_to, parse_splits_list,
)
from plankassembly_tpu_torch.data.noise import add_noise

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))
TRAIN64 = os.path.join(ROOT, "plankassembly_tpu_torch", "fixtures",
                       "train64.json.gz")
OVERRIDES = {"model.hparams.LR": "2e-5", "trainer.max_epochs": "20",
             "MODEL.DROPOUT": "0.0", "trainer.fused_attention": "false",
             "BATCH_SIZE": "8", "DATA.AUG_RATIO": "0.5",
             "trainer.decode_impl": "persistent"}


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_load_config_matches_jax(path):
    """Equal as `asdict`, value types included, bare and with overrides
    (`1e-4` strings coerced to floats the JAX way)."""
    for overrides in (None, OVERRIDES):
        ours = dataclasses.asdict(load_config(path, overrides))
        ref = dataclasses.asdict(jax_load_config(path, overrides))
        assert ours == ref
        assert type(ours["LR"]) is float


def test_yaml_reader_against_pyyaml_and_round_trip(tmp_path):
    import yaml
    for path in CONFIGS:
        ours, ref = read_hparams_yaml(path), yaml.safe_load(open(path))
        # PyYAML reads `1e-4` (no dot) as a string; the port as a float
        ref["model"]["hparams"]["LR"] = float(ref["model"]["hparams"]["LR"])
        assert ours == ref, path
    cfg = load_config(CONFIGS[0], OVERRIDES)
    out = tmp_path / "hparams.yaml"
    write_hparams_yaml(cfg, str(out))
    assert config_from_hparams_file(str(out)) == cfg
    bad = tmp_path / "bad.yaml"
    for text in ("a:\n  - 1\n", "a:\n    b: 1\n  c: 2\n", "a: [1, 2]\n"):
        bad.write_text(text)
        with pytest.raises(ValueError):
            read_hparams_yaml(str(bad))


@pytest.fixture(scope="module")
def train64():
    with gzip.open(TRAIN64, "rt") as f:
        return json.load(f)


@pytest.fixture(scope="module")
def info_dir(tmp_path_factory, train64):
    root = tmp_path_factory.mktemp("infos")
    for info in train64[:16]:
        with open(root / f"{info['name']}.json", "w") as f:
            json.dump(info, f)
    return root, [f"{i['name']}.json" for i in train64[:16]]


def test_geometry_matches_jax(train64):
    for svg in train64[0]["svgs"][:40]:
        a, b = geo.from_geojson(svg), jgeo.from_geojson(svg)
        np.testing.assert_array_equal(a, b)
        assert geo.length(a) == jgeo.length(b)
        for d in (0.0, 0.013, -0.02, 5.0, -5.0):
            np.testing.assert_array_equal(geo.interpolate(a, d),
                                          jgeo.interpolate(b, d))
    lines = [geo.from_geojson(s) for s in train64[1]["svgs"]]
    np.testing.assert_array_equal(geo.bounds_many(lines),
                                  jgeo.bounds_many(lines))
    assert geo.bounds_many([]).shape == (0, 4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_add_noise_same_draws_as_jax(train64, seed):
    info = train64[seed]
    lines = [geo.from_geojson(s) for s in info["svgs"]]
    ours = add_noise(lines, info["views"], info["types"], 0.3, 0.02,
                     rng=np.random.RandomState(seed))
    ref = jax_add_noise(lines, info["views"], info["types"], 0.3, 0.02,
                        rng=np.random.RandomState(seed))
    assert ours[1] == list(ref[1]) and ours[2] == list(ref[2])
    assert len(ours[0]) == len(ref[0]) < len(lines) + 1
    for a, b in zip(ours[0], ref[0]):
        np.testing.assert_array_equal(a, b)


def _cfg():
    cfg = load_config(os.path.join(ROOT, "configs",
                                   "train_synthetic_gqa.yaml"))
    jcfg = jax_load_config(os.path.join(ROOT, "configs",
                                        "train_synthetic_gqa.yaml"))
    return cfg, jcfg


@pytest.mark.parametrize("augment", [False, True], ids=["plain", "augmented"])
def test_line_dataset_matches_jax(info_dir, augment):
    """Every packed array equal, drawing by drawing; with augmentation
    (AUG_RATIO raised to 0.5 so that both kinds of read occur) under equal
    RandomState seeds."""
    root, names = info_dir
    cfg, jcfg = _cfg()
    if augment:
        cfg = dataclasses.replace(cfg, DATA=dataclasses.replace(
            cfg.DATA, AUG_RATIO=0.5))
        jcfg = dataclasses.replace(jcfg, DATA=dataclasses.replace(
            jcfg.DATA, AUG_RATIO=0.5))
    ours = LineDataset(str(root), names, cfg, augmentation=augment,
                       rng=np.random.RandomState(7))
    ref = JaxLineDataset(str(root), names, jcfg, augmentation=augment,
                         rng=np.random.RandomState(7))
    differs = 0
    for i in range(len(names)):
        a, b = ours[i], ref[i]
        assert sorted(a) == sorted(b)
        assert a["name"] == b["name"]
        for key in a:
            if key != "name":
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        plain = LineDataset(str(root), names, cfg)[i]
        differs += not np.array_equal(plain["input_value"], a["input_value"])
    assert (differs > 0) == augment


def test_dataloader_order_matches_jax(info_dir):
    root, names = info_dir
    cfg, jcfg = _cfg()
    ds = LineDataset(str(root), names, cfg)
    jds = JaxLineDataset(str(root), names, jcfg)
    for kw in (dict(shuffle=True, drop_last=True, seed=2022),
               dict(order=np.arange(len(names))[::-1], pad_to_batch=True),
               dict(shuffle=True, drop_last=False, seed=3, num_workers=3)):
        ours = DataLoader(ds, batch_size=5, **kw)
        ref = JaxDataLoader(jds, batch_size=5, **kw)
        for _ in range(2):  # two epochs: the shuffle RNG advances alike
            a, b = list(ours), list(ref)
            assert len(a) == len(b) == len(ours) == len(ref)
            for x, y in zip(a, b):
                assert x["name"] == y["name"]
                # '_rows' is the JAX loader's multi-host row range
                assert sorted(x) == sorted(set(y) - {"_rows"})
                for key in ("input_value", "output_label", "sample_valid"):
                    if key in y:
                        np.testing.assert_array_equal(x[key], np.asarray(
                            y[key]))
        ours.close()


def test_augmented_batches_do_not_depend_on_workers(info_dir):
    """Every row's augmentation draws are made in row order from the
    dataset's one RandomState, on the loader's own thread, so 0 and 4
    thread workers give the same batches."""
    root, names = info_dir
    cfg, _ = _cfg()
    cfg = dataclasses.replace(cfg, DATA=dataclasses.replace(
        cfg.DATA, AUG_RATIO=0.5))
    runs = []
    for workers in (0, 4):
        ds = LineDataset(str(root), names, cfg, augmentation=True,
                         rng=np.random.RandomState(11))
        loader = DataLoader(ds, batch_size=5, shuffle=True, seed=2,
                            num_workers=workers)
        runs.append([b for _ in range(2) for b in loader])
        loader.close()
    assert len(runs[0]) == len(runs[1]) > 0
    plain = {d["name"]: d["input_value"]
             for d in LineDataset(str(root), names, cfg)}
    differs = 0
    for x, y in zip(*runs):
        assert x["name"] == y["name"]
        for key in x:
            if key != "name":
                np.testing.assert_array_equal(x[key], y[key], err_msg=key)
        differs += sum(
            not np.array_equal(row, plain[n])
            for n, row in zip(x["name"], x["input_value"]))
    assert differs > 0


def test_pad_batch_to_and_splits(info_dir, tmp_path):
    root, names = info_dir
    cfg, _ = _cfg()
    ds = LineDataset(str(root), names, cfg)
    batch = {"input_value": np.stack([ds[0]["input_value"],
                                      ds[1]["input_value"]]),
             "name": ["a", "b"]}
    ours, valid = pad_batch_to(batch, 4)
    ref, rvalid = jax_pad_batch_to(batch, 4)
    np.testing.assert_array_equal(ours["input_value"], ref["input_value"])
    np.testing.assert_array_equal(valid, rvalid)
    assert ours["name"] == ["a", "b", "a", "a"]  # lists are padded too
    split = tmp_path / "train.txt"
    split.write_text("".join(n + "\n" for n in names[:3]))
    assert parse_splits_list(f"{split} extra.json") == names[:3] + [
        "extra.json"]
    with pytest.raises(NotImplementedError):
        parse_splits_list("x.csv")
