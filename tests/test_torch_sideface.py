"""The port's sideface modality on the CPU against the JAX package: the
arrangement geometry, side-face extraction, request packing, the sideface
dataset, a live sideface backend, `serve --no_input_type` over HTTP, the
sideface and visible trainers, and the committed sideface golden
(`plankassembly_tpu_torch/data/sideface_data.py`, `serving.py`,
`serve.py`, `train/loop.py`, `fixtures/`)."""
import dataclasses
import gzip
import json
import os
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plankassembly_tpu.config import config_from_hparams_file as jax_config
from plankassembly_tpu.data import geometry as jgeo
from plankassembly_tpu.data.noise import add_noise as jax_add_noise
from plankassembly_tpu.data.sideface_data import (
    SidefaceDataset as JaxSidefaceDataset,
)
from plankassembly_tpu.data.sideface_data import (
    extract_sidefaces as jax_extract,
)
from plankassembly_tpu.models.model import ModelDims as JaxDims
from plankassembly_tpu.models.model import init_params
from plankassembly_tpu.serving import make_live_backend as jax_live_backend
from plankassembly_tpu.serving import pack_info_dict as jax_pack_info
from plankassembly_tpu_torch import serve, serving
from plankassembly_tpu_torch.checkpoint import load_checkpoint, params_from_jax
from plankassembly_tpu_torch.config import (
    ModelDims, config_from_hparams_file, write_hparams_yaml,
)
from plankassembly_tpu_torch.data import geometry as geo
from plankassembly_tpu_torch.data.sideface_data import (
    SidefaceDataset, extract_sidefaces,
)
from plankassembly_tpu_torch.decode import greedy_decode
from plankassembly_tpu_torch.train.loop import (
    SidefaceTrainer, Trainer, VisibleTrainer,
)
from plankassembly_tpu_torch.train.state import init_state
from tests.make_torch_sideface_golden import REQUESTS, sideface_requests
from tests.test_torch_train_e2e import _port_cfg
from tests.tiny import tiny_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "plankassembly_tpu_torch", "fixtures")
HP = os.path.join(ROOT, "checkpoints", "gqa_sideface_ep119.hparams.yaml")
# a drawing with no side face: one dangling line
EMPTY = {"name": "empty", "views": [0], "types": [0],
         "svgs": [jgeo.to_geojson(np.array([[0.0, 0.0], [0.3, 0.0]]))],
         "lines": [[0.0, 0.0, 0.3, 0.0]]}


def _fixture(name):
    with gzip.open(os.path.join(FIX, f"{name}.json.gz"), "rt") as f:
        return json.load(f)


@pytest.fixture(scope="module")
def drawings():
    """The 128 fixture drawings with `svgs`: the training fixture's own,
    and the serving fixture's from its lines."""
    return _fixture("train64") + sideface_requests(_fixture("serve64"))


def _thresholds(cfg):
    d = cfg.DATA
    return (d.MAX_THICKNESS / d.SCALE, d.MERGE_TOLERANCE / d.SCALE,
            d.MIN_THICKNESS / d.SCALE)


def _arrangement(seed, n=24):
    """Random axis-aligned segments on a coarse grid (so that segments
    meet, cross and close faces), some of them polylines and some
    degenerate."""
    rng = np.random.default_rng(seed)
    grid = np.round(rng.uniform(-1, 1, 9), 3)
    lines = []
    for _ in range(n):
        a, b = rng.choice(grid, 2), rng.choice(grid, 2)
        if rng.random() < 0.5:
            line = [[a[0], b[0]], [a[1], b[0]]]
        else:
            line = [[b[0], a[0]], [b[0], a[1]]]
        if rng.random() < 0.2:  # a polyline turning a corner
            line.append([line[-1][0], rng.choice(grid)])
        lines.append(np.array(line, dtype=np.float64))
    return lines


@pytest.mark.parametrize("seed", range(6))
def test_polygonize_and_aabb_equal_jax(seed):
    """polygonize_bounds and segments_intersect_aabb: exact equality with
    the JAX package on seeded random axis-aligned arrangements."""
    lines = _arrangement(seed)
    ours, ref = geo.polygonize_bounds(lines), jgeo.polygonize_bounds(lines)
    assert ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)
    if seed == 0:
        assert len(ref) > 0  # the arrangements close faces
    for i, a in enumerate(lines):
        for b in lines[i:]:
            for tol in (0.0, 1e-3):
                assert geo.segments_intersect_aabb(a, b, tol) is \
                    jgeo.segments_intersect_aabb(a, b, tol)
        assert geo.to_geojson(a) == jgeo.to_geojson(a)
    assert geo.polygonize_bounds([]).shape == (0, 4)


@pytest.mark.parametrize("noisy", [False, True], ids=["clean", "noisy"])
def test_extract_sidefaces_equal_jax_on_all_fixture_drawings(drawings, noisy):
    """All 128 drawings, clean and after add_noise with the same
    RandomState: faces and faceviews equal."""
    cfg = config_from_hparams_file(HP)
    for k, info in enumerate(drawings):
        lines = [geo.from_geojson(s) for s in info["svgs"]]
        views, types = np.asarray(info["views"]), np.asarray(info["types"])
        if noisy:
            lines, views, _ = jax_add_noise(lines, views, types, 0.15, 0.02,
                                            rng=np.random.RandomState(k))
        faces, fviews = extract_sidefaces(lines, views, *_thresholds(cfg))
        rfaces, rviews = jax_extract(lines, views, *_thresholds(cfg))
        np.testing.assert_array_equal(faces, rfaces)
        np.testing.assert_array_equal(fviews, rviews)
        assert fviews.dtype == rviews.dtype
        assert len(faces) > 0


def test_pack_info_dict_sideface_equals_jax(drawings):
    """Every drawing packs to the JAX package's streams, with no
    input_type; a request without svgs raises ValueError in both; a
    drawing with no side face packs to END and PAD only."""
    cfg, jcfg = config_from_hparams_file(HP), jax_config(HP)
    for info in drawings + [EMPTY]:
        ours = serving.pack_info_dict(info, cfg, with_type=False)
        ref = jax_pack_info(info, jcfg, with_type=False)
        assert sorted(ours) == sorted(ref)
        assert "input_type" not in ours
        for k in ref:
            assert ours[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(ours[k], ref[k])
    empty = serving.pack_info_dict(EMPTY, cfg, with_type=False)
    assert empty["input_value"][0] == cfg.TOKEN.END
    assert (empty["input_value"][1:] == cfg.TOKEN.PAD).all()
    assert not empty["input_mask"][0] and empty["input_mask"][1:].all()
    no_svgs = {k: v for k, v in drawings[0].items() if k != "svgs"}
    for pack, c in ((serving.pack_info_dict, cfg), (jax_pack_info, jcfg)):
        with pytest.raises(ValueError, match="svgs"):
            pack(no_svgs, c, with_type=False)


def _write_infos(root, infos):
    os.makedirs(root, exist_ok=True)
    names = []
    for info in infos:
        full = {"coords": [[0.0] * 6], "attach": [[-1] * 6], **info}
        with open(os.path.join(root, f"{info['name']}.json"), "w") as f:
            json.dump(full, f)
        names.append(f"{info['name']}.json")
    return names


@pytest.mark.parametrize("augment", [False, True], ids=["clean", "augmented"])
def test_sideface_dataset_rows_equal_jax(drawings, tmp_path, augment):
    """SidefaceDataset rows, drawing by drawing, equal the JAX dataset's;
    with augmentation (AUG_RATIO 0.5) under equal RandomState seeds, and
    with a packed-sample cache."""
    root = str(tmp_path / "infos")
    names = _write_infos(root, drawings[:12] + [EMPTY])
    jcfg = jax_config(HP)
    jcfg = dataclasses.replace(jcfg, DATA=dataclasses.replace(
        jcfg.DATA, AUG_RATIO=0.5))
    cfg = _port_cfg(jcfg)
    for cache in (None, str(tmp_path / "cache")):
        ours = SidefaceDataset(root, names, cfg,
                               augmentation=augment,
                               rng=np.random.RandomState(3), cache_dir=cache)
        ref = JaxSidefaceDataset(root, names, jcfg,
                                 augmentation=augment,
                                 rng=np.random.RandomState(3),
                                 cache_dir=cache)
        for i in range(len(names)):
            a, b = ours[i], ref[i]
            assert sorted(a) == sorted(b) and a["name"] == b["name"]
            assert "input_type" not in a
            for key in b:
                if key != "name":
                    np.testing.assert_array_equal(a[key], b[key],
                                                  err_msg=key)
        # the degenerate drawing reads as its clean sample, END and PAD
        row = ours.read(len(names) - 1, np.random.RandomState(0))
        assert (row["input_value"][1:] == cfg.TOKEN.PAD).all()


# ------------------------------------------------------------- serving
LI = 200  # tiny model's input length: the fixture's 10..41 faces fit


def _tiny_model():
    jcfg = tiny_config()
    jcfg = dataclasses.replace(
        jcfg, DATA=dataclasses.replace(jcfg.DATA, MAX_INPUT_LENGTH=LI,
                                       MAX_OUTPUT_LENGTH=48),
        MODEL=dataclasses.replace(jcfg.MODEL, NUM_KV_HEAD=1))
    params = init_params(jax.random.PRNGKey(0), JaxDims.from_config(jcfg))
    return jcfg, params


def _upto_end(row, end):
    hits = np.flatnonzero(row == end)
    return row[: hits[0] + 1] if hits.size else row


def test_sideface_live_backend_equals_jax_decode(drawings):
    """make_live_backend(with_type=False) on the CPU with the JAX
    initialization converted: the 8 sideface requests (a zero-face one
    among them) decode to the JAX backend's tokens in f32, exactly."""
    jcfg, jparams = _tiny_model()
    cfg = _port_cfg(jcfg)
    infos = drawings[:7] + [EMPTY]
    packed = [serving.pack_info_dict(i, cfg, with_type=False) for i in infos]
    request = {k: np.stack([p[k] for p in packed]) for k in packed[0]}
    backend, meta = serving.make_live_backend(
        params_from_jax(jax.tree.map(np.asarray, jparams)), cfg, batch=8,
        bucket=LI - 1, compute_dtype=torch.float32, device="cpu",
        with_type=False)
    jbackend, jmeta = jax_live_backend(jparams, jcfg, batch=8,
                                       bucket=LI - 1,
                                       compute_dtype=jnp.float32,
                                       with_type=False)
    assert meta["with_type"] is False and "input_type" not in \
        meta["input_keys"]
    assert meta["input_keys"] == jmeta["input_keys"]
    assert meta["input_dtypes"] == jmeta["input_dtypes"]
    ours, ref = backend(request), jbackend(request)
    end = cfg.TOKEN.END
    for a, b, x, y in zip(ours["samples"], ref["samples"], ours["attach"],
                          ref["attach"]):
        n = len(_upto_end(b, end))
        np.testing.assert_array_equal(a[:n], b[:n])
        np.testing.assert_array_equal(x[:n], y[:n])


@pytest.fixture(scope="module")
def sideface_ckpt(tmp_path_factory):
    """A tiny released-style sideface checkpoint: a float32 npz of the JAX
    initialization beside its hparams."""
    root = tmp_path_factory.mktemp("sideface_ckpt")
    jcfg, params = _tiny_model()
    flat = {"/".join(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_leaves_with_path(params)}
    ckpt = root / "tiny.npz"
    np.savez(ckpt, **flat)
    write_hparams_yaml(_port_cfg(jcfg), str(root / "tiny.hparams.yaml"))
    return str(ckpt)


def _post(base, path, obj):
    req = urllib.request.Request(base + path, data=json.dumps(obj).encode())
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def test_serve_no_input_type_end_to_end(drawings, sideface_ckpt):
    """`serve --no_input_type --bucket 64 199 --cpu`: each sideface request
    is answered by the smallest bucket that fits its packed face tokens
    (not its line count), equal to the direct decode there; a request
    without svgs answers 400."""
    httpd, server = serve.make_server(
        ["--ckpt", sideface_ckpt, "--cpu", "--port", "0", "--batch", "2",
         "--bucket", "199", "64", "--no_input_type", "--max_wait_ms", "1"])
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    params, cfg = load_checkpoint(sideface_ckpt, device="cpu")
    dims = ModelDims.from_config(cfg)
    try:
        assert server.meta["buckets"] == [64, 199]
        assert server.meta["with_type"] is False
        infos = sorted(drawings[64:], key=lambda i: len(i["lines"]))[:3] \
            + [EMPTY]
        by_faces = []
        for info in infos:
            status, out = _post(base, "/v1/reconstruct", info)
            assert status == 200, out
            packed = serving.pack_info_dict(info, cfg, with_type=False)
            n_real = int((~packed["input_mask"]).sum())
            bucket = 64 if n_real <= 64 else 199
            assert out["bucket"] == bucket
            by_faces.append(bucket == 64 and 4 * len(info["lines"]) + 1 > 64)
            want = greedy_decode(
                params, {k: torch.from_numpy(v[None])
                         for k, v in packed.items()}, dims,
                compute_dtype=torch.bfloat16, kv_bucket=bucket,
                kv_quant=True)
            pred, attach = serving.postprocess_prediction(
                want["samples"][0].numpy(), want["attach"][0].numpy(), dims)
            assert out["prediction"] == pred.tolist()
            assert out["attach"] == attach
        # a drawing whose lines would not fit the small bucket, whose
        # faces do
        assert any(by_faces)
        status, out = _post(base, "/v1/reconstruct",
                            {k: v for k, v in infos[0].items()
                             if k != "svgs"})
        assert status == 400 and "svgs" in out["error"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()


def test_sideface_golden_fixture():
    """The committed JAX sideface golden: its requests, buckets, face
    counts (those the port's packing gives) and trained-checkpoint F1."""
    golden = np.load(os.path.join(FIX, "serve64_sideface_jax_golden.npz"))
    assert tuple(golden["requests"]) == REQUESTS
    cfg = config_from_hparams_file(HP)
    infos = sideface_requests(_fixture("serve64"))
    faces = [(int((~serving.pack_info_dict(i, cfg, with_type=False)
                   ["input_mask"]).sum()) - 1) // 4 for i in infos]
    np.testing.assert_array_equal(golden["face_counts"], faces)
    for name in ("bf16", "f32"):
        assert golden[f"samples_{name}"].shape == (64, 128)
        assert 0.9 < float(golden[f"f1_{name}"].mean()) <= 1.0
    first = 0
    for n, bucket in zip(REQUESTS, golden["buckets"]):
        assert bucket >= 4 * golden["face_counts"][first:first + n].max() + 1
        first += n


# ------------------------------------------------------------- trainers
def _tiny_dataset(root):
    """Two factory drawings and the degenerate one, as in
    `tests/test_sideface_e2e.py`."""
    from plankassembly_tpu.factory.projection import (
        VIEWS, postprocess_complete, project_boxes,
    )
    from plankassembly_tpu.factory.synthetic import generate_cabinet
    os.makedirs(root / "infos")
    names = []
    for seed in range(2):
        planks, attach = generate_cabinet(seed, max_planks=5)
        svgs, views, types_all = [], [], []
        for v_i, view in enumerate(VIEWS):
            lines, types = project_boxes(planks[1:] / 1280.0, view)
            lines, types = postprocess_complete(lines, types)
            svgs.extend(jgeo.to_geojson(line) for line in lines)
            types_all.extend(types)
            views.extend([v_i] * len(lines))
        info = {"name": f"s{seed}", "views": views, "types": types_all,
                "svgs": svgs,
                "lines": [jgeo.bounds(jgeo.from_geojson(s)).tolist()
                          for s in svgs],
                "coords": np.round(planks / 1280.0, 3).tolist(),
                "attach": attach.tolist()}
        with open(root / "infos" / f"s{seed}.json", "w") as f:
            json.dump(info, f)
        names.append(f"s{seed}")
    planks, attach = generate_cabinet(9, max_planks=5)
    with open(root / "infos" / "empty.json", "w") as f:
        json.dump({**EMPTY, "coords": np.round(planks / 1280.0, 3).tolist(),
                   "attach": attach.tolist()}, f)
    names.append("empty")
    with open(root / "split.txt", "w") as f:
        f.write("".join(f"{n}.json\n" for n in names))


def _trainer_cfg(root, log_root, **data):
    jcfg = tiny_config()
    return dataclasses.replace(
        jcfg, ROOT=str(root / "infos"),
        DATASETS_TRAIN=str(root / "split.txt"),
        DATASETS_VALID=str(root / "split.txt"),
        DATASETS_TEST=str(root / "split.txt"), BATCH_SIZE=3,
        DATA=dataclasses.replace(jcfg.DATA, MAX_INPUT_LENGTH=304,
                                 MAX_OUTPUT_LENGTH=48, **data),
        trainer=dataclasses.replace(jcfg.trainer, devices=1, max_epochs=1,
                                    check_val_every_n_epoch=1,
                                    default_root_dir=str(log_root)))


def test_sideface_trainer_fit_and_test_equal_jax(tmp_path):
    """SidefaceTrainer fits, then tests from the JAX initialization: its
    prediction JSONs equal the JAX SidefaceTrainer's, the degenerate
    drawing's included (no planks, zero scores, left out of the
    criterion), and none carries `attach`."""
    from plankassembly_tpu.train import SidefaceTrainer as JaxSideface
    _tiny_dataset(tmp_path)
    jcfg = _trainer_cfg(tmp_path, tmp_path / "logs", AUG_RATIO=0.5)
    trainer = SidefaceTrainer(_port_cfg(jcfg), compute_dtype=torch.float32,
                              device="cpu")
    state = trainer.fit(max_epochs=1)
    assert state.step == 1
    assert trainer.train_augmentation and trainer.dataset_cls is \
        SidefaceDataset

    jtrainer = JaxSideface(jcfg, compute_dtype=jnp.float32)
    jstate = jtrainer.init_state()
    port_state = init_state(params_from_jax(jax.tree.map(
        np.asarray, jstate.params)), trainer.optimizer, device="cpu")
    scores = trainer.test(port_state)
    jscores = jtrainer.test(jstate)
    np.testing.assert_allclose(scores, jscores, rtol=0, atol=1e-12)
    ours_dir = os.path.join(trainer.log_dir, "pred_jsons")
    ref_dir = os.path.join(jtrainer.log_dir, "pred_jsons")
    assert sorted(os.listdir(ours_dir)) == sorted(os.listdir(ref_dir)) == [
        "empty.json", "s0.json", "s1.json"]
    for name in os.listdir(ref_dir):
        with open(os.path.join(ours_dir, name)) as f:
            ours = json.load(f)
        with open(os.path.join(ref_dir, name)) as f:
            ref = json.load(f)
        assert ours == ref, name
        assert "attach" not in ours
    with open(os.path.join(ours_dir, "empty.json")) as f:
        empty = json.load(f)
    assert empty["prediction"] == [] and empty["fmeasure"] == 0.0


def test_visible_trainer_never_augments(tmp_path):
    """VisibleTrainer's training split is read clean whatever AUG_RATIO
    says, as the JAX VisibleTrainer's; the complete trainer's is not."""
    from plankassembly_tpu.train import VisibleTrainer as JaxVisible
    from plankassembly_tpu_torch.data.line_data import LineDataset
    from tests.tiny import write_tiny_dataset
    names = write_tiny_dataset(str(tmp_path))
    jcfg = tiny_config()
    jcfg = dataclasses.replace(
        jcfg, ROOT=str(tmp_path / "infos"),
        DATASETS_TRAIN=str(tmp_path / "train.txt"), BATCH_SIZE=2,
        DATA=dataclasses.replace(jcfg.DATA, MAX_INPUT_LENGTH=320,
                                 MAX_OUTPUT_LENGTH=48, AUG_RATIO=1.0),
        trainer=dataclasses.replace(
            jcfg.trainer, default_root_dir=str(tmp_path / "logs")))
    assert VisibleTrainer.train_augmentation is \
        JaxVisible.train_augmentation is False
    cfg = _port_cfg(jcfg)
    ds = LineDataset(cfg.ROOT, [f"{n}.json" for n in names], cfg)
    clean = {r["name"]: r["input_value"] for r in map(ds.__getitem__,
                                                      range(len(ds)))}
    for cls, augmented in ((VisibleTrainer, False), (Trainer, True)):
        trainer = cls(cfg, device="cpu")
        loader = trainer.train_dataloader()
        assert loader.dataset.augmentation is augmented
        differs = [not np.array_equal(value, clean[name])
                   for _ in range(2) for batch in loader
                   for name, value in zip(batch["name"],
                                          batch["input_value"])]
        assert len(differs) == 2 * len(ds)
        assert any(differs) is augmented
        loader.close()
        trainer.close()


def test_trainer_modules_pick_their_trainer(tmp_path):
    """`python -m plankassembly_tpu_torch.trainer_{complete,visible,
    sideface}` run the CLI with their modality's trainer."""
    import subprocess
    import sys
    from plankassembly_tpu_torch import cli
    _tiny_dataset(tmp_path)
    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(f"""trainer:
  max_epochs: 1
  check_val_every_n_epoch: 1
  log_every_n_steps: 1
  default_root_dir: {tmp_path / 'runs'}
model:
  hparams:
    ROOT: {tmp_path / 'infos'}
    DATASETS_TRAIN: {tmp_path / 'split.txt'}
    DATASETS_VALID: {tmp_path / 'split.txt'}
    DATASETS_TEST: {tmp_path / 'split.txt'}
    BATCH_SIZE: 3
    NUM_WORKERS: 0
    DATA:
      MAX_INPUT_LENGTH: 304
      MAX_OUTPUT_LENGTH: 48
    MODEL:
      NUM_MODEL: 16
      NUM_HEAD: 2
      NUM_FEEDFORWARD: 32
      NUM_ENCODER_LAYERS: 1
      NUM_DECODER_LAYERS: 1
""")
    argv = ["fit", "--config", str(cfg_path), "--device", "cpu",
            "--trainer.sample_cache", "true"]
    for main, cls in ((cli.main_complete, Trainer),
                      (cli.main_visible, VisibleTrainer),
                      (cli.main_sideface, SidefaceTrainer)):
        trainer, state = main(argv)
        assert type(trainer) is cls and state.step == 1
        assert trainer.cfg.trainer.sample_cache
    for mod in ("trainer_complete", "trainer_visible", "trainer_sideface"):
        out = subprocess.run(
            [sys.executable, "-m", f"plankassembly_tpu_torch.{mod}",
             "--help"], capture_output=True, text=True, cwd=ROOT,
            timeout=120)
        assert out.returncode == 0 and "fit --config" in out.stdout
