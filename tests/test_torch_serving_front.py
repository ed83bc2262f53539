"""The port's serving front end on the CPU (`plankassembly_tpu_torch/
serving.py`): the cases of the JAX package's `tests/test_serve.py` —
the dynamic batcher against direct decode, the HTTP routes and errors,
concurrent requests sharing a batch, an invalid request failing alone,
the bucket ladder's routing and errors, submit after close — and the beam
backend."""
import dataclasses
import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from plankassembly_tpu.models.model import ModelDims as JaxDims
from plankassembly_tpu.models.model import init_params
from plankassembly_tpu.serving import pack_info_dict as jax_pack_info
from plankassembly_tpu_torch import serving
from plankassembly_tpu_torch.beam import beam_decode
from plankassembly_tpu_torch.checkpoint import params_from_jax
from plankassembly_tpu_torch.config import ModelDims
from plankassembly_tpu_torch.decode import greedy_decode
from tests.test_torch_train_e2e import _port_cfg
from tests.tiny import random_batch, tiny_config

BUCKET = 31


def _tiny_info(seed=0, n=7):  # 7 lines * 4 dof + END = 29 <= tiny Li 31
    rng = np.random.default_rng(seed)
    lo = rng.uniform(-1, 0, (n, 2))
    hi = lo + rng.uniform(0.05, 0.9, (n, 2))
    lines = np.concatenate([lo, np.minimum(hi, 0.999)], axis=1)
    return {"name": f"tiny{seed}",
            "lines": lines.round(3).tolist(),
            "views": (np.arange(n) % 3).tolist(),
            "types": (np.arange(n) % 2).tolist()}


def _model(max_input_length=32):
    jcfg = tiny_config()
    jcfg = dataclasses.replace(jcfg, DATA=dataclasses.replace(
        jcfg.DATA, MAX_INPUT_LENGTH=max_input_length))
    params = init_params(jax.random.PRNGKey(0), JaxDims.from_config(jcfg))
    cfg = _port_cfg(jcfg)
    return cfg, ModelDims.from_config(cfg), params_from_jax(
        jax.tree.map(np.asarray, params))


def _inputs(sample):
    return {k: v for k, v in sample.items() if k.startswith("input")}


def _direct(params, sample, dims, bucket, **kw):
    batch = {k: torch.from_numpy(v[None]) for k, v in _inputs(sample).items()}
    return greedy_decode(params, batch, dims, compute_dtype=torch.float32,
                         kv_bucket=bucket, kv_quant=True, **kw)


@pytest.fixture(scope="module")
def served():
    cfg, dims, params = _model()
    backend, meta = serving.make_live_backend(
        params, cfg, batch=2, bucket=BUCKET, compute_dtype=torch.float32,
        device="cpu")
    server = serving.BatchingServer(backend, meta, max_wait_ms=300.0)
    httpd = serving.make_http_server(server, cfg, dims, port=0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    yield cfg, dims, params, server, base
    httpd.shutdown()
    httpd.server_close()
    server.close()


def _post(base, path, obj, timeout=120):
    req = urllib.request.Request(
        base + path, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def _get(base, path):
    try:
        with urllib.request.urlopen(base + path, timeout=30) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def test_batcher_matches_direct_decode(served):
    cfg, dims, params, server, base = served
    batch = random_batch(cfg, seed=3)
    row = server.submit({k: v[0] for k, v in _inputs(batch).items()})
    want = _direct(params, {k: v[0] for k, v in batch.items()}, dims, BUCKET)
    np.testing.assert_array_equal(row["samples"], want["samples"][0].numpy())
    np.testing.assert_array_equal(row["attach"], want["attach"][0].numpy())


def test_http_reconstruct_and_health(served):
    cfg, dims, params, server, base = served
    code, out = _post(base, "/v1/reconstruct", _tiny_info(1))
    assert code == 200, out
    assert out["name"] == "tiny1"
    pred = np.asarray(out["prediction"])
    assert pred.ndim == 2 and pred.shape[1] == dims.num_output_dof
    assert len(out["attach"]) == len(out["prediction"])
    # the answer equals the offline pipeline on the same request, which
    # packs it as the JAX package does
    sample = serving.pack_info_dict(_tiny_info(1), cfg)
    for k, v in jax_pack_info(_tiny_info(1), tiny_config()).items():
        np.testing.assert_array_equal(sample[k], v)
    want = _direct(params, sample, dims, BUCKET)
    want_pred, want_attach = serving.postprocess_prediction(
        want["samples"][0].numpy(), want["attach"][0].numpy(), dims)
    np.testing.assert_array_equal(pred, want_pred)
    assert out["attach"] == want_attach

    code, health = _get(base, "/healthz")
    assert code == 200 and health["ok"] and health["rows_served"] >= 1
    code, meta = _get(base, "/meta")
    assert code == 200 and meta["batch"] == 2 and meta["bucket"] == BUCKET
    assert meta["beam"] == 0 and meta["platforms"] == ["cpu"]


def test_concurrent_requests_share_a_batch(served):
    cfg, dims, params, server, base = served
    results = [None, None]

    def hit(i):
        results[i] = _post(base, "/v1/reconstruct", _tiny_info(10 + i))

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    rows = [r[1]["batched_rows"] for r in results if r and r[0] == 200]
    assert len(rows) == 2, results
    assert max(rows) == 2, "requests arriving within max_wait must batch"


def test_http_errors(served):
    cfg, dims, params, server, base = served
    assert _post(base, "/v1/bogus", {})[0] == 404
    assert _get(base, "/v2/nothing")[0] == 404
    code, out = _post(base, "/v1/reconstruct", {"views": [0]})  # no lines
    assert code == 500 and "error" in out
    # the request's own faults: more tokens than the model takes, a
    # malformed number
    code, out = _post(base, "/v1/reconstruct", _tiny_info(5, n=12))
    assert code == 400 and "exceed" in out["error"], out
    code, out = _post(base, "/v1/reconstruct", {**_tiny_info(1),
                                                "lines": [["x"] * 4]})
    assert code == 400 and "error" in out


def test_invalid_request_does_not_poison_batchmates(served):
    """A request whose real tokens exceed the bucket fails alone at submit
    time; a valid request in the same batching window is served."""
    cfg, dims, params, server, base = served
    wide = dataclasses.replace(cfg, DATA=dataclasses.replace(
        cfg.DATA, MAX_INPUT_LENGTH=64))
    long_sample = serving.pack_info_dict(_tiny_info(5, n=12), wide)
    results = [None, None]

    def bad():
        try:
            server.submit(_inputs(long_sample))
            results[0] = "no error"
        except ValueError as e:
            results[0] = str(e)

    def good():
        results[1] = _post(base, "/v1/reconstruct", _tiny_info(6))

    threads = [threading.Thread(target=bad), threading.Thread(target=good)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert "beyond the bucket" in results[0]
    assert results[1][0] == 200, results[1]


def test_sideface_requests_raise_until_ported():
    """Sideface requests are ported: one with only `lines` raises
    ValueError (side faces come from `svgs`), as in JAX; one with `svgs`
    packs with no type stream, and the backend's contract has none."""
    cfg, dims, params = _model()
    with pytest.raises(ValueError, match="svgs"):
        serving.pack_info_dict(_tiny_info(1), cfg, with_type=False)
    with pytest.raises(ValueError, match="svgs"):
        jax_pack_info(_tiny_info(1), cfg, with_type=False)
    square = [[[0.0, 0.0], [0.5, 0.0]], [[0.5, 0.0], [0.5, 0.01]],
              [[0.5, 0.01], [0.0, 0.01]], [[0.0, 0.01], [0.0, 0.0]]]
    info = {"svgs": [json.dumps({"type": "LineString", "coordinates": c})
                     for c in square], "views": [0] * 4, "types": [0] * 4}
    packed = serving.pack_info_dict(info, cfg, with_type=False)
    assert "input_type" not in packed
    assert int((~packed["input_mask"]).sum()) == 4 + 1  # one face + END
    backend, meta = serving.make_live_backend(
        params, cfg, batch=2, bucket=BUCKET, compute_dtype=torch.float32,
        device="cpu", with_type=False)
    assert not meta["with_type"] and "input_type" not in meta["input_keys"]
    out = backend({k: v[None] for k, v in packed.items()})
    assert out["samples"].shape == (1, dims.max_output_length)


def test_bucket_router_routes_by_real_tokens():
    """A ladder (31, 63) of one model: each request lands in the smallest
    bucket that fits its real tokens, equal to the direct decode at that
    bucket, over HTTP too; one beyond the ladder fails with a clear error
    (400 over HTTP)."""
    cfg, dims, params = _model(max_input_length=64)
    servers = []
    for bucket in (63, 31):
        backend, meta = serving.make_live_backend(
            params, cfg, batch=2, bucket=bucket, compute_dtype=torch.float32,
            device="cpu")
        servers.append(serving.BatchingServer(backend, meta, max_wait_ms=1.0))
    router = serving.BucketRouter(servers)
    httpd = serving.make_http_server(router, cfg, dims, port=0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        assert router.meta["buckets"] == [31, 63]
        short = serving.pack_info_dict(_tiny_info(2), cfg)      # 29 real
        long = serving.pack_info_dict(_tiny_info(3, n=14), cfg)  # 57 real
        for sample, bucket in ((short, 31), (long, 63)):
            out = router.submit(_inputs(sample))
            assert out["bucket"] == bucket
            want = _direct(params, sample, dims, bucket)
            np.testing.assert_array_equal(out["samples"],
                                          want["samples"][0].numpy())
        code, out = _post(base, "/v1/reconstruct", _tiny_info(3, n=14))
        assert code == 200 and out["bucket"] == 63, out
        assert _get(base, "/meta")[1]["buckets"] == [31, 63]
        assert _get(base, "/healthz")[1]["rows_served"] == 3

        wide = dataclasses.replace(cfg, DATA=dataclasses.replace(
            cfg.DATA, MAX_INPUT_LENGTH=128))
        too_long = serving.pack_info_dict(_tiny_info(5, n=17), wide)
        with pytest.raises(ValueError, match="largest bucket"):
            router.submit(_inputs(too_long))
    finally:
        httpd.shutdown()
        httpd.server_close()
        router.close()


def test_bucket_router_rejects_bad_ladders():
    cfg, dims, params = _model()
    meta = serving.serving_meta(dims, batch=2, bucket=BUCKET, device="cpu")

    def server(**over):
        return serving.BatchingServer(lambda r: r, {**meta, **over},
                                      max_wait_ms=1.0)

    ladders = (([], "at least one"),
               ([server(), server()], "duplicate buckets"),
               ([server(), server(bucket=63, token_end=7)], "token_end"))
    for servers, match in ladders:
        with pytest.raises(ValueError, match=match):
            serving.BucketRouter(servers)
        for s in servers:
            s.close()


def test_beam_backend_equals_beam_decode():
    cfg, dims, params = _model()
    backend, meta = serving.make_live_backend(
        params, cfg, batch=2, bucket=BUCKET, beam=2,
        compute_dtype=torch.float32, device="cpu")
    assert meta["beam"] == 2
    batch = _inputs(random_batch(cfg, seed=4))
    out = backend(batch)
    want = beam_decode(params, {k: torch.from_numpy(v) for k, v in
                                batch.items()}, dims, num_beams=2,
                       compute_dtype=torch.float32)
    np.testing.assert_array_equal(out["samples"], want["samples"].numpy())
    np.testing.assert_array_equal(out["attach"], want["attach"].numpy())


def test_submit_after_close_rejected():
    cfg, dims, params = _model()
    meta = {"batch": 1, "bucket": BUCKET, "token_pad": dims.pad,
            "token_end": dims.end, "input_keys": ["input_value",
                                                  "input_mask"]}
    server = serving.BatchingServer(lambda req: req, meta, max_wait_ms=1.0)
    server.close()
    with pytest.raises(RuntimeError, match="closed"):
        server.submit({"input_value": np.zeros(4, np.int32),
                       "input_mask": np.ones(4, bool)})
