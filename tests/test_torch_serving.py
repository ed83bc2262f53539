"""The port's serving path and metrics against the JAX package, and the
committed serving fixture (`plankassembly_tpu_torch/serving.py`,
`metrics.py`, `data/packing.py`, `fixtures/`)."""
import dataclasses
import gzip
import json
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plankassembly_tpu.config import config_from_hparams_file as jax_config
from plankassembly_tpu.data.packing import pack_output_sequence as jax_pack_out
from plankassembly_tpu.metrics import batch_scores as jax_batch_scores
from plankassembly_tpu.metrics import hungarian_match_host as jax_hungarian
from plankassembly_tpu.metrics import metric_sums as jax_metric_sums
from plankassembly_tpu.serving import pack_info_dict as jax_pack_info
from plankassembly_tpu_torch import metrics, serving
from plankassembly_tpu_torch.config import ModelDims, config_from_hparams_file
from plankassembly_tpu_torch.data.packing import pack_output_sequence
from plankassembly_tpu_torch.decode import greedy_decode, parse_sequence
from tests.make_torch_golden import make_infos
from tests.test_torch_decode import END_CASES, _port, _setup

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "plankassembly_tpu_torch", "fixtures")
HP = os.path.join(ROOT, "checkpoints", "gqa_complete_ep221.hparams.yaml")


def _infos():
    with gzip.open(os.path.join(FIX, "serve64.json.gz"), "rt") as f:
        return json.load(f)


def test_fixture_size_and_shape():
    infos = _infos()
    assert len(infos) == 64
    assert all(set(i) == {"name", "lines", "views", "types", "coords",
                          "attach"} for i in infos)
    total = sum(os.path.getsize(os.path.join(FIX, n)) for n in os.listdir(FIX))
    assert total < 1_000_000, total
    golden = np.load(os.path.join(FIX, "serve64_jax_golden.npz"))
    for name in ("bf16", "f32"):
        assert golden[f"samples_{name}"].shape == (64, 128)
        assert 0.0 < float(golden[f"f1_{name}"].mean()) <= 1.0


@pytest.mark.parametrize("first", [0, 16, 32, 48])
def test_fixture_drawings_equal_the_factory(first):
    """Each drawing (16 per case, all 64 in all) equals what the JAX
    package's factory and SVG round trip give for its seed."""
    infos = _infos()
    idx = list(range(first, first + 16))
    fresh = make_infos([900000 + i for i in idx])
    for i, info in zip(idx, fresh):
        assert infos[i] == json.loads(json.dumps(info))


def test_pack_info_dict_identical_to_jax():
    cfg = config_from_hparams_file(HP)
    jcfg = jax_config(HP)
    for info in _infos():
        ours = serving.pack_info_dict(info, cfg)
        ref = jax_pack_info(info, jcfg)
        assert ours.keys() == ref.keys()
        for k in ref:
            assert ours[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(ours[k], ref[k])
        out_ours = pack_output_sequence(np.array(info["coords"]).flatten(),
                                        np.array(info["attach"]).flatten(),
                                        cfg.DATA, cfg.TOKEN)
        out_ref = jax_pack_out(np.array(info["coords"]).flatten(),
                               np.array(info["attach"]).flatten(),
                               jcfg.DATA, jcfg.TOKEN)
        for k in out_ref:
            np.testing.assert_array_equal(out_ours[k], out_ref[k])
    # a request with only `svgs`, and none of them: both pack it alike
    empty = {"svgs": [], "views": [], "types": []}
    ours, ref = serving.pack_info_dict(empty, cfg), jax_pack_info(empty, jcfg)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k])


def test_svgs_only_requests_pack_like_jax():
    """Each train64 drawing with `lines` taken away packs from its `svgs`
    (GeoJSON linestrings -> bounding boxes) to the arrays JAX packs, in
    all six input streams."""
    cfg = config_from_hparams_file(HP)
    jcfg = jax_config(HP)
    with gzip.open(os.path.join(FIX, "train64.json.gz"), "rt") as f:
        infos = json.load(f)
    assert len(infos) == 64
    for info in infos:
        req = {k: v for k, v in info.items() if k != "lines"}
        ours = serving.pack_info_dict(req, cfg)
        ref = jax_pack_info(req, jcfg)
        assert sorted(ours) == sorted(ref) == sorted(serving._INPUT_DTYPES)
        for k in ref:
            assert ours[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
        # the svgs carry the same lines as the drawing's own `lines`
        np.testing.assert_array_equal(
            ours["input_value"], serving.pack_info_dict(info, cfg)[
                "input_value"])


def _perturbed(gt, rng):
    """Predictions near the ground truth: shifted coordinates, dropped and
    duplicated planks, zero-extent planks, missing END."""
    out = gt.copy()
    for row in out:
        ends = np.flatnonzero(row == 512)
        n = int(ends[0]) if ends.size else len(row)
        k = rng.integers(0, 4)
        if k == 0:  # jitter some coordinates
            sel = rng.random(n) < 0.2
            row[:n][sel] = np.clip(row[:n][sel] + rng.integers(-30, 30,
                                                               sel.sum()),
                                   0, 511)
        elif k == 1 and n > 12:  # drop the last plank
            row[n - 6:n] = row[n:n + 6] if n + 6 <= len(row) else 513
            row[n - 6] = 512
        elif k == 2 and n >= 12:  # a zero-extent plank
            row[6:9] = row[9:12]
        else:  # no END at all
            row[row == 512] = 7
    return out


def test_batch_scores_identical_to_jax():
    golden = np.load(os.path.join(FIX, "serve64_jax_golden.npz"))
    gt = golden["gt_samples"]
    rng = np.random.default_rng(0)
    for pred in (golden["samples_bf16"], _perturbed(gt, rng),
                 _perturbed(gt, rng), gt):
        ours = metrics.batch_scores(torch.from_numpy(pred),
                                    torch.from_numpy(gt))
        ref = jax_batch_scores(jnp.asarray(pred), jnp.asarray(gt))
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        metrics.batch_scores(torch.from_numpy(golden["samples_f32"]),
                             torch.from_numpy(gt))[2].numpy(),
        golden["f1_f32"])
    valid = np.arange(len(gt)) % 3 != 0
    ours = metrics.metric_sums(torch.from_numpy(pred), torch.from_numpy(gt),
                               torch.from_numpy(valid))
    ref = jax_metric_sums(jnp.asarray(pred), jnp.asarray(gt),
                          jnp.asarray(valid))
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)


def test_hungarian_matches_jax():
    rng = np.random.default_rng(1)
    for _ in range(20):
        a = rng.uniform(0, 1, (rng.integers(1, 8), 6)).astype(np.float32)
        a[:, 3:] += a[:, :3]
        b = a[rng.permutation(len(a))] + rng.normal(0, .05, a.shape)
        assert metrics.hungarian_match_host(a, b) == jax_hungarian(a, b)


def test_batching_server_equals_direct_decode():
    """Concurrent single-sample requests through `BatchingServer` over the
    CPU backend decode to the same rows as one direct `greedy_decode`
    (float32; rows decode independently, so exact)."""
    seed, bias = END_CASES["staggered"][1]
    cfg, _, params, batch = _setup(1, bias, seed=seed, batch_size=6)
    tparams, tbatch = _port(params, batch)
    dims = ModelDims.from_config(cfg)
    bucket = 32
    direct = greedy_decode(tparams, tbatch, dims, compute_dtype=torch.float32,
                           kv_bucket=bucket, kv_quant=True)
    backend, meta = serving.make_live_backend(
        tparams, cfg, batch=4, bucket=bucket, compute_dtype=torch.float32,
        device="cpu")
    server = serving.BatchingServer(backend, meta, max_wait_ms=50)
    rows = [None] * 6

    def ask(i):
        rows[i] = server.submit({k: np.asarray(v[i]) for k, v in
                                 batch.items()}, timeout=60)

    threads = [threading.Thread(target=ask, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    server.close()
    assert not any(t.is_alive() for t in threads)
    assert server.rows_served == 6 and server.batches_run >= 2
    for i, row in enumerate(rows):
        want = direct["samples"][i].numpy()
        np.testing.assert_array_equal(parse_sequence(row["samples"], dims),
                                      parse_sequence(want, dims))
        n = row["num_steps"]
        np.testing.assert_array_equal(row["samples"][:n], want[:n])
        np.testing.assert_array_equal(row["attach"][:n],
                                      direct["attach"][i].numpy()[:n])
        pred, attach = serving.postprocess_prediction(row["samples"],
                                                      row["attach"], dims)
        assert len(attach) == len(pred)


def test_pad_request_validates():
    cfg = dataclasses.replace(config_from_hparams_file(HP))
    meta = serving.serving_meta(ModelDims.from_config(cfg), batch=2,
                                bucket=8)
    req = {k: np.zeros((3, 8), np.int32) for k in meta["input_keys"]}
    req["input_mask"] = np.zeros((3, 8), bool)
    with pytest.raises(ValueError, match="split the request"):
        serving.pad_request(req, meta)
    req = {k: v[:2] for k, v in req.items()}
    req = {k: np.pad(v, ((0, 0), (0, 2))) for k, v in req.items()}
    with pytest.raises(ValueError, match="beyond the bucket"):
        serving.pad_request(req, meta)
