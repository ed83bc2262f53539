"""The port's serving artifacts on the CPU (`plankassembly_tpu_torch/
export.py`, `export_serving.py`, `predict --artifact`, `serve --artifact`),
case for case with `tests/test_export_serving.py`: an artifact answers as
the live decode of the same weights and options does, bit for bit, its
header round-trips with JAX `serving_meta`'s keys, row padding is inert,
and bad requests, exports and files are refused."""
import dataclasses
import json
import os
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plankassembly_tpu.beam import beam_decode as jax_beam_decode
from plankassembly_tpu.decode import greedy_decode as jax_greedy_decode
from plankassembly_tpu.export import save_artifact as jax_save_artifact
from plankassembly_tpu.export import serving_meta as jax_serving_meta
from plankassembly_tpu.models.model import ModelDims as JaxDims
from plankassembly_tpu.models.model import init_params
from plankassembly_tpu_torch import export_serving, predict, serve
from plankassembly_tpu_torch.beam import beam_decode
from plankassembly_tpu_torch.checkpoint import load_checkpoint, params_from_jax
from plankassembly_tpu_torch.config import ModelDims, write_hparams_yaml
from plankassembly_tpu_torch.decode import (
    greedy_decode, quantize_decoder_weights,
)
from plankassembly_tpu_torch.export import (
    export_serving as export, load_artifact, save_artifact,
)
from plankassembly_tpu_torch.serving import pack_info_dict
from tests.test_torch_train_e2e import _port_cfg
from tests.tiny import random_batch, tiny_config, write_tiny_dataset

BUCKET = 31  # the tiny config's MAX_INPUT_LENGTH - 1


@pytest.fixture(scope="module")
def setup():
    jcfg = tiny_config()
    jparams = init_params(jax.random.PRNGKey(0), JaxDims.from_config(jcfg))
    cfg = _port_cfg(jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    batch = {k: v for k, v in random_batch(jcfg).items()
             if k.startswith("input")}
    return cfg, ModelDims.from_config(cfg), params, jparams, batch


def _saved(tmp_path, params, cfg, name="a.ptrv", **kw):
    blob, meta = export(params, cfg, batch=2, bucket=BUCKET,
                        compute_dtype=torch.float32, **kw)
    path = str(tmp_path / name)
    save_artifact(path, blob, meta)
    return path


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _live(params, batch, dims, beam=0):
    if beam:
        return beam_decode(params, _torch(batch), dims, num_beams=beam,
                           compute_dtype=torch.float32)
    return greedy_decode(params, _torch(batch), dims,
                         compute_dtype=torch.float32, kv_bucket=BUCKET,
                         kv_quant=True, cross_impl="mxu")


def _equal(got, want):
    np.testing.assert_array_equal(got["samples"], np.asarray(want["samples"]))
    np.testing.assert_array_equal(got["attach"], np.asarray(want["attach"]))


def test_artifact_matches_live_decode(setup, tmp_path):
    """The artifact's programs equal the port's live decode with the same
    options, and JAX's decode of the same weights (f32, tokens exact)."""
    cfg, dims, params, jparams, batch = setup
    got = load_artifact(_saved(tmp_path, params, cfg), device="cpu")(batch)
    want = _live(params, batch, dims)
    _equal(got, want)
    assert int(got["num_steps"]) == int(want["num_steps"])
    _equal(got, jax_greedy_decode(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()},
        JaxDims.from_config(tiny_config()), compute_dtype=jnp.float32,
        kv_bucket=BUCKET, kv_quant=True, cross_impl="mxu"))


def test_header_round_trip(setup, tmp_path):
    cfg, dims, params, _, _ = setup
    m = load_artifact(_saved(tmp_path, params, cfg), device="cpu").meta
    assert m["format"] == "PTRV1"
    assert m["batch"] == 2 and m["bucket"] == BUCKET and m["beam"] == 0
    assert m["platforms"] == ["cpu"]  # where it was loaded
    assert m["token_end"] == dims.end and m["token_pad"] == dims.pad
    assert sorted(m["input_keys"]) == sorted(m["input_dtypes"])
    assert m["early_exit"] and not m["weight_quant"]
    assert m["compute_dtype"] == "float32"
    assert ModelDims(**m["model"]) == dims
    assert m["decode"] == {"cross_impl": "mxu"}


def test_header_keys_are_jax_serving_meta_keys(setup):
    """The port's header carries JAX `serving_meta`'s keys and values of
    the same contract, plus `model` and `decode`."""
    cfg, _, params, _, _ = setup
    _, meta = export(params, cfg, batch=2, bucket=BUCKET,
                     compute_dtype=torch.float32)
    ref = jax_serving_meta(JaxDims.from_config(tiny_config()), batch=2,
                           bucket=BUCKET, compute_dtype=jnp.float32)
    assert set(meta) - {"model", "decode"} == set(ref)
    for key in set(ref) - {"format", "platforms"}:
        assert meta[key] == ref[key], key
    assert (meta["format"], ref["format"]) == ("PTRV1", "PSRV1")


def test_row_padding_is_inert(setup, tmp_path):
    cfg, _, params, _, batch = setup
    prog = load_artifact(_saved(tmp_path, params, cfg), device="cpu")
    full = prog(batch)
    one = prog({k: v[:1] for k, v in batch.items()})
    assert one["samples"].shape[0] == 1
    np.testing.assert_array_equal(one["samples"][0], full["samples"][0])
    np.testing.assert_array_equal(one["attach"][0], full["attach"][0])


def test_oversized_request_rejected(setup, tmp_path):
    cfg, _, params, _, batch = setup
    prog = load_artifact(_saved(tmp_path, params, cfg), device="cpu")
    with pytest.raises(ValueError, match="rows"):
        prog({k: np.concatenate([v, v]) for k, v in batch.items()})


def test_real_tokens_beyond_bucket_rejected(setup, tmp_path):
    cfg, _, params, _, _ = setup
    prog = load_artifact(_saved(tmp_path, params, cfg), device="cpu")
    wide = tiny_config()
    wide = dataclasses.replace(wide, DATA=dataclasses.replace(
        wide.DATA, MAX_INPUT_LENGTH=40))
    inputs = {k: v for k, v in random_batch(wide).items()
              if k.startswith("input")}
    assert inputs["input_value"].shape[1] > BUCKET
    with pytest.raises(ValueError, match="beyond the bucket"):
        prog(inputs)


def test_beam_artifact_matches_live_beam(setup, tmp_path):
    cfg, dims, params, jparams, batch = setup
    prog = load_artifact(_saved(tmp_path, params, cfg, beam=2), device="cpu")
    assert prog.meta["beam"] == 2 and not prog.meta["early_exit"]
    got = prog(batch)
    _equal(got, _live(params, batch, dims, beam=2))
    _equal(got, jax_beam_decode(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()},
        JaxDims.from_config(tiny_config()), num_beams=2,
        compute_dtype=jnp.float32))


@pytest.mark.parametrize("beam", [0, 2], ids=["greedy", "beam2"])
def test_weight_quant_artifact(setup, tmp_path, beam):
    """int8 decoder and head weights: a smaller file whose programs equal
    the live decode of the same pre-quantized weights, greedy and beam."""
    cfg, dims, params, _, batch = setup
    plain = _saved(tmp_path, params, cfg, "f.ptrv", beam=beam)
    path = _saved(tmp_path, params, cfg, "q.ptrv", beam=beam,
                  weight_quant=True)
    assert os.path.getsize(path) < os.path.getsize(plain)
    prog = load_artifact(path, device="cpu")
    assert prog.meta["weight_quant"] is True
    assert prog.params["decoder"]["ffn"]["w1"]["q"].dtype == torch.int8
    _equal(prog(batch), _live(quantize_decoder_weights(params), batch, dims,
                              beam=beam))


def test_released_weights_are_stored_as_bf16(setup, tmp_path):
    """Weights that bf16 holds exactly are stored as bf16 and come back
    equal; the file is about half the float32 one."""
    cfg, dims, params, _, batch = setup
    wide = _saved(tmp_path, params, cfg, "f32.ptrv")
    bf = jax.tree.map(lambda t: t.to(torch.bfloat16).float(), params)
    path = _saved(tmp_path, bf, cfg, "bf16.ptrv")
    assert os.path.getsize(path) < 0.6 * os.path.getsize(wide)
    prog = load_artifact(path, device="cpu")
    for (a, b) in zip(jax.tree.leaves(prog.params), jax.tree.leaves(bf)):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    _equal(prog(batch), _live(bf, batch, dims))


def test_sideface_contract_no_type_stream(setup, tmp_path):
    cfg, dims, params, _, _ = setup
    prog = load_artifact(_saved(tmp_path, params, cfg, with_type=False),
                         device="cpu")
    assert "input_type" not in prog.meta["input_keys"]
    inputs = {k: v for k, v in random_batch(tiny_config(), with_type=False)
              .items() if k.startswith("input")}
    _equal(prog(inputs), _live(params, inputs, dims))


def test_unsupported_export_combos_rejected(setup):
    cfg, _, params, _, _ = setup
    with pytest.raises(ValueError, match="must divide"):
        export(params, cfg, batch=3, bucket=BUCKET, data_parallel=2)
    # a data-parallel artifact exports; its header carries the split
    _, meta = export(params, cfg, batch=4, bucket=BUCKET, data_parallel=2)
    assert meta["data_parallel"] == 2
    with pytest.raises(ValueError, match="trained input width"):
        export(params, cfg, batch=2, bucket=BUCKET + 1)


def test_bad_magic_and_jax_artifact_rejected(setup, tmp_path):
    cfg, dims, _, _, _ = setup
    junk = tmp_path / "junk.ptrv"
    junk.write_bytes(b"NOTPSRV" + b"\0" * 64)
    with pytest.raises(ValueError, match="not a PTRV1"):
        load_artifact(str(junk), device="cpu")
    jax_file = str(tmp_path / "jax.psrv")
    jax_save_artifact(jax_file, b"", jax_serving_meta(
        JaxDims.from_config(tiny_config()), batch=2, bucket=BUCKET))
    with pytest.raises(ValueError, match="JAX PSRV1"):
        load_artifact(jax_file, device="cpu")


@pytest.fixture(scope="module")
def ladder(tmp_path_factory):
    """A tiny dataset, a released-style checkpoint of the JAX
    initialization, and its artifacts at buckets 160 and 319 written by
    `python -m plankassembly_tpu_torch.export_serving --verify`."""
    root = tmp_path_factory.mktemp("export_cli")
    names = write_tiny_dataset(str(root))
    jcfg = tiny_config()
    jcfg = dataclasses.replace(jcfg, DATA=dataclasses.replace(
        jcfg.DATA, MAX_INPUT_LENGTH=320, MAX_OUTPUT_LENGTH=48))
    params = init_params(jax.random.PRNGKey(0), JaxDims.from_config(jcfg))
    flat = {"/".join(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_leaves_with_path(params)}
    ckpt = str(root / "tiny.npz")
    np.savez(ckpt, **flat)
    hp = str(root / "tiny.hparams.yaml")
    write_hparams_yaml(_port_cfg(jcfg), hp)
    outs = export_serving.main(["--ckpt", ckpt, "--out",
                                str(root / "art" / "tiny.ptrv"), "--batch",
                                "2", "--bucket", "160,319", "--dtype",
                                "float32", "--cpu", "--verify"])
    return root, ckpt, hp, names, outs


def _direct(ckpt, packed, bucket):
    params, cfg = load_checkpoint(ckpt, device="cpu")
    dims = ModelDims.from_config(cfg)
    batch = {k: torch.from_numpy(np.stack([p[k] for p in packed]))
             for k in packed[0]}
    out = greedy_decode(params, batch, dims, compute_dtype=torch.float32,
                        kv_bucket=bucket, kv_quant=True, cross_impl="mxu")
    return dims, out["samples"].numpy(), out["attach"].numpy()


def test_export_cli_writes_a_verified_ladder(ladder):
    root, ckpt, hp, names, outs = ladder
    assert [os.path.basename(p) for p in outs] == ["tiny.k160.ptrv",
                                                    "tiny.k319.ptrv"]
    metas = [load_artifact(p, device="cpu").meta for p in outs]
    assert [m["bucket"] for m in metas] == [160, 319]
    assert all(m["checkpoint"] == "tiny.npz" and m["batch"] == 2
               and m["compute_dtype"] == "float32" for m in metas)


def test_predict_artifact_equals_the_live_decode(ladder, tmp_path):
    """`predict --artifact`: each prediction is the live decode's of the
    same batch (the artifact's size, in the CLI's length order)."""
    from plankassembly_tpu_torch.serving import postprocess_prediction

    root, ckpt, hp, names, outs = ladder
    n = predict.main(["--artifact", outs[1], "--hparams", hp, "--info_dir",
                      str(root / "infos"), "--out", str(tmp_path), "--cpu"])
    assert n == len(names)
    _, cfg = load_checkpoint(ckpt, device="cpu")
    samples = sorted((predict.sample_from_info(
        str(root / "infos" / f"{name}.json"), cfg) for name in names),
        key=lambda s: int((~s[1]["input_mask"]).sum()))
    for lo in range(0, len(samples), 2):
        chunk = samples[lo:lo + 2]
        dims, rows, att = _direct(ckpt, [s[1] for s in chunk], 319)
        for i, (name, _) in enumerate(chunk):
            pred, attach = postprocess_prediction(rows[i], att[i], dims)
            with open(tmp_path / f"{name}.json") as f:
                got = json.load(f)
            assert got == {"prediction": pred.tolist(), "attach": attach}


def test_serve_artifact_ladder_over_http(ladder):
    """`serve --artifact a b`: each answer comes from the smallest bucket
    that fits and equals the live decode there; /meta shows the widest
    header and the ladder."""
    from plankassembly_tpu_torch.serving import postprocess_prediction

    root, ckpt, hp, names, outs = ladder
    httpd, server = serve.make_server(["--artifact", *outs, "--hparams", hp,
                                       "--cpu", "--port", "0",
                                       "--max_wait_ms", "1"])
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    _, cfg = load_checkpoint(ckpt, device="cpu")
    try:
        with urllib.request.urlopen(base + "/meta", timeout=60) as r:
            meta = json.loads(r.read().decode())
        assert meta["buckets"] == [160, 319] and meta["format"] == "PTRV1"
        buckets = set()
        for name in names:
            with open(root / "infos" / f"{name}.json") as f:
                info = json.load(f)
            req = urllib.request.Request(
                base + "/v1/reconstruct", data=json.dumps(info).encode())
            with urllib.request.urlopen(req, timeout=120) as r:
                out = json.loads(r.read().decode())
            packed = pack_info_dict(info, cfg)
            n_real = int((~packed["input_mask"]).sum())
            bucket = 160 if n_real <= 160 else 319
            assert out["bucket"] == bucket
            buckets.add(bucket)
            dims, rows, att = _direct(ckpt, [packed], bucket)
            pred, attach = postprocess_prediction(rows[0], att[0], dims)
            assert out["prediction"] == pred.tolist()
            assert out["attach"] == attach
        assert buckets == {160, 319}
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()
    t.join(timeout=10)
    assert not t.is_alive()
