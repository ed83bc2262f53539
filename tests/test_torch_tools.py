"""The port's command-line tools on the CPU: `python -m
plankassembly_tpu_torch.predict` (info JSONs and view SVGs, meshes),
`.serve` and `.evaluate`, and the numpy-only `io/svg.py` / `io/mesh.py`
copies, against the JAX package's tools and modules."""
import dataclasses
import json
import os
import subprocess
import sys
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from plankassembly_tpu.io import mesh as jax_mesh
from plankassembly_tpu.io import svg as jax_svg
from plankassembly_tpu.models.model import ModelDims as JaxDims
from plankassembly_tpu.models.model import init_params
from plankassembly_tpu.tokens import dequantize_values as jax_dequantize
from plankassembly_tpu.tokens import quantize_values
from plankassembly_tpu_torch import predict, serve
from plankassembly_tpu_torch.checkpoint import load_checkpoint
from plankassembly_tpu_torch.config import ModelDims, write_hparams_yaml
from plankassembly_tpu_torch.decode import greedy_decode, pick_kv_bucket
from plankassembly_tpu_torch.io import mesh as port_mesh
from plankassembly_tpu_torch.io import svg as port_svg
from plankassembly_tpu_torch.serving import postprocess_prediction
from tests.test_torch_train_e2e import _port_cfg
from tests.tiny import tiny_config, write_tiny_dataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIEW_SVGS = ("tmp_f.svg", "tmp_t.svg", "tmp_s.svg")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A tiny dataset (its last drawing's three view SVGs left in the root)
    and a tiny released-style checkpoint: a float32 npz of the JAX
    initialization beside its hparams."""
    root = tmp_path_factory.mktemp("tools")
    names = write_tiny_dataset(str(root))
    jcfg = tiny_config()
    jcfg = dataclasses.replace(jcfg, DATA=dataclasses.replace(
        jcfg.DATA, MAX_INPUT_LENGTH=320, MAX_OUTPUT_LENGTH=48))
    params = init_params(jax.random.PRNGKey(0), JaxDims.from_config(jcfg))
    flat = {"/".join(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_leaves_with_path(params)}
    ckpt = root / "tiny.npz"
    np.savez(ckpt, **flat)
    write_hparams_yaml(_port_cfg(jcfg), str(root / "tiny.hparams.yaml"))
    return root, str(ckpt), names


def _direct_rows(ckpt, samples, **kw):
    """The greedy decode predict runs, on `samples` (name, packed) as one
    batch in the CLI's length order."""
    params, cfg = load_checkpoint(ckpt, device="cpu")
    dims = ModelDims.from_config(cfg)
    samples = sorted(samples, key=lambda s: int((~s[1]["input_mask"]).sum()))
    batch = {k: torch.from_numpy(np.stack([s[1][k] for s in samples]))
             for k in samples[0][1]}
    out = greedy_decode(params, batch, dims, compute_dtype=torch.bfloat16,
                        kv_bucket=pick_kv_bucket(batch["input_mask"]),
                        kv_quant=True, **kw)
    return dims, {name: (out["samples"][i].numpy(), out["attach"][i].numpy())
                  for i, (name, _) in enumerate(samples)}


def _read(path):
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("mesh", ["stl", "glb"])
def test_predict_info_and_svg_with_meshes(setup, tmp_path, mesh):
    """--info (repeated) and --svg in one call: one JSON per drawing equal
    to the direct decode of the same batch, and each mesh byte for byte
    what the JAX package's io.mesh writes for that prediction."""
    root, ckpt, names = setup
    infos = [str(root / "infos" / f"{n}.json") for n in names]
    svgs = [str(root / v) for v in VIEW_SVGS]
    out = tmp_path / "preds"
    n = predict.main(["--cpu", "--ckpt", ckpt, "--out", str(out),
                      "--info", *infos[:2], "--info", *infos[2:],
                      "--svg", *svgs, "--mesh", mesh])
    assert n == len(names) + 1
    _, cfg = load_checkpoint(ckpt, device="cpu")
    samples = [predict.sample_from_info(p, cfg) for p in infos]
    samples.append(predict.sample_from_svgs(svgs, cfg))
    dims, rows = _direct_rows(ckpt, samples)
    n_mesh = 0
    for name, (row, att) in rows.items():
        rec = _read(out / f"{name}.json")
        assert set(rec) == {"prediction", "attach"}
        pred, attach = postprocess_prediction(row, att, dims)
        assert rec["prediction"] == pred.tolist()
        assert rec["attach"] == attach
        if len(pred) > 1:
            verts, faces = jax_mesh.build_mesh(jax_dequantize(pred))
            ref = tmp_path / f"ref.{mesh}"
            (jax_mesh.export_stl if mesh == "stl" else
             jax_mesh.export_glb)(str(ref), verts, faces)
            assert (out / f"{name}.{mesh}").read_bytes() == ref.read_bytes()
            n_mesh += 1
    assert n_mesh > 0


def test_predict_svg_packing_matches_jax(setup):
    from tools.predict import load_params_and_config
    from tools.predict import sample_from_svgs as jax_from_svgs

    root, ckpt, _ = setup
    svgs = [str(root / v) for v in VIEW_SVGS]
    _, jcfg = load_params_and_config(ckpt)
    _, cfg = load_checkpoint(ckpt, device="cpu")
    got = predict.sample_from_svgs(svgs, cfg)[1]
    ref = jax_from_svgs(svgs, jcfg)[1]
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("extra,kw", [
    (["--beam", "2", "--batch", "2"], None),
    (["--decode_impl", "mxu", "--batch", "8"], dict(cross_impl="mxu"))],
    ids=["beam2", "mxu"])
def test_predict_info_dir_beam_and_decode_impl(setup, tmp_path, extra, kw):
    root, ckpt, names = setup
    out = tmp_path / "preds"
    assert predict.main(["--cpu", "--ckpt", ckpt, "--out", str(out),
                         "--info_dir", str(root / "infos")] + extra) == \
        len(names)
    for name in names:
        rec = _read(out / f"{name}.json")
        assert len(rec["attach"]) == len(rec["prediction"])
    if kw is not None:
        _, cfg = load_checkpoint(ckpt, device="cpu")
        samples = [predict.sample_from_info(
            str(root / "infos" / f"{n}.json"), cfg) for n in names]
        dims, rows = _direct_rows(ckpt, samples, **kw)
        for name, (row, att) in rows.items():
            pred, _ = postprocess_prediction(row, att, dims)
            assert _read(out / f"{name}.json")["prediction"] == pred.tolist()


def test_cli_flags_waiting_for_later_slices(setup, tmp_path, capsys):
    root, ckpt, _ = setup
    for mod, argv in ((predict, ["--ckpt", ckpt, "--out", str(tmp_path),
                                 "--artifact", "a.psrv"]),
                      (serve, ["--ckpt", ckpt, "--artifact", "a.psrv"])):
        with pytest.raises(SystemExit):
            mod.parse_args(argv)
        assert "not ported yet" in capsys.readouterr().err
    # sideface serving is ported: the flag parses
    assert serve.parse_args(["--ckpt", ckpt, "--no_input_type"]).no_input_type
    for mod in (predict, serve):
        with pytest.raises(SystemExit):
            mod.parse_args(["--help"])
        assert "not ported yet (ROADMAP.md" in capsys.readouterr().out


def test_serve_cli_ladder_over_http(setup):
    """`serve --bucket 128 319 --weight_quant --cpu`: a ladder whose answers
    name their bucket and equal the direct int8-weight decode there."""
    from plankassembly_tpu_torch.decode import quantize_decoder_weights
    from plankassembly_tpu_torch.serving import pack_info_dict

    root, ckpt, names = setup
    httpd, server = serve.make_server(
        ["--ckpt", ckpt, "--cpu", "--port", "0", "--batch", "2",
         "--bucket", "319", "128", "--weight_quant", "--max_wait_ms", "1"])
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    params, cfg = load_checkpoint(ckpt, device="cpu")
    qparams = quantize_decoder_weights(params)
    dims = ModelDims.from_config(cfg)
    try:
        assert server.meta["buckets"] == [128, 319]
        assert server.meta["weight_quant"]
        for name in names:
            info = _read(root / "infos" / f"{name}.json")
            req = urllib.request.Request(
                base + "/v1/reconstruct", data=json.dumps(info).encode())
            with urllib.request.urlopen(req, timeout=120) as r:
                out = json.loads(r.read().decode())
            packed = pack_info_dict(info, cfg)
            n_real = int((~packed["input_mask"]).sum())
            bucket = 128 if n_real <= 128 else 319
            assert out["bucket"] == bucket
            want = greedy_decode(
                qparams, {k: torch.from_numpy(v[None])
                          for k, v in packed.items()}, dims,
                compute_dtype=torch.bfloat16, kv_bucket=bucket,
                kv_quant=True)
            pred, attach = postprocess_prediction(
                want["samples"][0].numpy(), want["attach"][0].numpy(), dims)
            assert out["prediction"] == pred.tolist()
            assert out["attach"] == attach
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()


def test_evaluate_prints_what_the_root_evaluate_prints(setup, tmp_path):
    """Both evaluators on one prediction directory (a perfect, a perturbed
    and an empty prediction, and the tiny model's own): the same printed
    numbers and metrics.json."""
    root, ckpt, names = setup
    exp = tmp_path / "exp"
    pred_dir = exp / "pred_jsons"
    predict.main(["--cpu", "--ckpt", ckpt, "--out", str(pred_dir),
                  "--info", str(root / "infos" / f"{names[3]}.json")])
    coords = [np.array(_read(root / "infos" / f"{n}.json")["coords"])
              for n in names[:3]]
    perturbed = quantize_values(coords[1])
    perturbed[2:, :3] += 9
    for name, pred in zip(names, (quantize_values(coords[0]), perturbed,
                                  np.zeros((0, 6), int))):
        with open(pred_dir / f"{name}.json", "w") as f:
            json.dump({"prediction": pred.tolist()}, f)
    outs = []
    for cmd in ([os.path.join(ROOT, "evaluate.py")],
                ["-m", "plankassembly_tpu_torch.evaluate"]):
        r = subprocess.run(
            [sys.executable, *cmd, "--data_path", str(root),
             "--exp_path", str(exp)], capture_output=True, text=True,
            timeout=300, cwd=ROOT, env={**os.environ, "PYTHONPATH": ROOT})
        assert r.returncode == 0, r.stderr[-2000:]
        outs.append((r.stdout, _read(exp / "metrics.json")))
    assert outs[0] == outs[1]
    assert "f1 100.000" not in outs[0][0] and len(outs[0][1]) == 3
    assert outs[0][1][names[0]]["fmeasure"] > 0.999


def test_svg_io_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    lines = [rng.uniform(-1, 1, (2, 2)) for _ in range(12)]
    types = rng.integers(0, 2, 12).tolist()
    noise = rng.integers(0, 3, 12).tolist()
    for mod, name in ((port_svg, "port.svg"), (jax_svg, "jax.svg")):
        mod.render_svg(str(tmp_path / name), lines, types, noise)
    assert (tmp_path / "port.svg").read_text() == \
        (tmp_path / "jax.svg").read_text()
    got, ref = (mod.parse_svg(str(tmp_path / "jax.svg"))
                for mod in (port_svg, jax_svg))
    assert got[1] == ref[1] and len(got[0]) == len(ref[0]) == \
        sum(n != 1 for n in noise)
    for a, b in zip(got[0], ref[0]):
        np.testing.assert_array_equal(a, b)


def test_mesh_io_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    lo = rng.uniform(-1, 0.5, (5, 3))
    planks = np.concatenate([lo, lo + rng.uniform(0.05, 0.5, (5, 3))], 1)
    got, ref = port_mesh.build_mesh(planks), jax_mesh.build_mesh(planks)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    for fn in ("export_stl", "export_glb"):
        getattr(port_mesh, fn)(str(tmp_path / "a"), *ref)
        getattr(jax_mesh, fn)(str(tmp_path / "b"), *ref)
        assert (tmp_path / "a").read_bytes() == (tmp_path / "b").read_bytes()
    empty = port_mesh.build_mesh(planks[:1])
    assert empty[0].shape == (0, 3) and empty[1].shape == (0, 3)


def test_clis_need_cuda_unless_cpu(setup, tmp_path, monkeypatch):
    """Without --cpu the CLIs ask for the GPU and raise when CUDA is
    absent, instead of running on the CPU."""
    root, ckpt, names = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    info = str(root / "infos" / f"{names[0]}.json")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        predict.main(["--ckpt", ckpt, "--out", str(tmp_path), "--info", info])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.make_server(["--ckpt", ckpt, "--port", "0"])
    assert not os.listdir(tmp_path)


def test_profile_tool_busy_time_is_the_union_of_intervals():
    """tools/profile_torch_serve.py's device busy time: kernels that
    overlap (programmatic dependent launch) count once, gaps not at all,
    in any order; the idle share stays in [0, 1]."""
    from tools.profile_torch_serve import busy_union
    spans = [(0.0, 10.0), (5.0, 12.0), (11.0, 11.5), (20.0, 25.0),
             (24.0, 30.0), (40.0, 40.0)]
    assert busy_union(spans) == 12.0 + 10.0
    assert busy_union(reversed(spans)) == 22.0
    assert busy_union([]) == 0.0
    assert busy_union([(3.0, 4.0)] * 5) == 1.0
    # with a wall of 24, the summed times (28.5) would give an idle
    # share below 0; the union gives 1 - 22/24
    wall = 24.0
    assert 1 - sum(b - a for a, b in spans) / wall < 0.0
    assert 1 - busy_union(spans) / wall == 1 - 22.0 / 24.0
