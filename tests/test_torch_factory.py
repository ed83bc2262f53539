"""The port's offline data factory (`plankassembly_tpu_torch/factory/`) and
its dataset tools (`plankassembly_tpu_torch/tools/{generate_models,
render_svgs,prepare_info}.py`) against the JAX package's, on the same
seeds: equal arrays, byte-identical files, and the fixtures regenerated."""
import argparse
import gzip
import hashlib
import json
import os
import sys

import numpy as np
import pytest

from plankassembly_tpu.factory import native as jax_native
from plankassembly_tpu.factory import projection as jax_proj
from plankassembly_tpu.factory import synthetic as jax_syn
from plankassembly_tpu_torch import factory as port_factory
from plankassembly_tpu_torch.factory import native as port_native
from plankassembly_tpu_torch.factory import projection as port_proj
from plankassembly_tpu_torch.factory import synthetic as port_syn
from plankassembly_tpu_torch.tools import (
    generate_models, prepare_info, render_svgs,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
FIXTURES = os.path.join(ROOT, "plankassembly_tpu_torch", "fixtures")
SEEDS = list(range(0, 25)) + list(range(900000, 900025))


def _boxes(seed):
    planks, _ = jax_syn.generate_cabinet(seed)
    return planks[1:] / 1280.0


def _same_lines(a, b):
    (la, ta), (lb, tb) = a, b
    assert ta == tb
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_generate_cabinet_equals_jax():
    for seed in SEEDS:
        planks, attach = port_syn.generate_cabinet(seed)
        ref_planks, ref_attach = jax_syn.generate_cabinet(seed)
        np.testing.assert_array_equal(planks, ref_planks)
        np.testing.assert_array_equal(attach, ref_attach)
        assert planks.dtype == ref_planks.dtype
        port_syn.validate_program(planks, attach)
        assert port_syn.generate_model_json(seed) == \
            jax_syn.generate_model_json(seed)
    small = port_syn.generate_cabinet(7, max_planks=5)
    np.testing.assert_array_equal(small[0],
                                  jax_syn.generate_cabinet(7, max_planks=5)[0])


def test_validate_program_rejects_what_jax_rejects():
    planks, attach = port_syn.generate_cabinet(3)
    bad = planks.copy()
    bad[1, 0] += 1.0  # breaks the pointer's value equality
    for mod in (port_syn, jax_syn):
        with pytest.raises(AssertionError):
            mod.validate_program(bad, attach)


@pytest.mark.parametrize("view", ["f", "t", "s"])
def test_projection_and_postprocess_equal_jax(view):
    """Every step of the projection, numpy path and native path, and both
    postprocesses give JAX's arrays in JAX's order."""
    for seed in SEEDS[::4]:
        boxes = _boxes(seed)
        segs, depths, owners = port_proj.box_view_segments(boxes, view)
        ref = jax_proj.box_view_segments(boxes, view)
        for x, y in zip((segs, depths, owners), ref):
            np.testing.assert_array_equal(x, y)
        for x, y in zip(port_proj._silhouettes(boxes, view),
                        jax_proj._silhouettes(boxes, view)):
            np.testing.assert_array_equal(x, y)
        for x, y in zip(port_proj._node_segments(segs),
                        jax_proj._node_segments(segs)):
            np.testing.assert_array_equal(x, y)
        for use_native in (False, True):
            got = port_proj.project_boxes(boxes, view, use_native=use_native)
            want = jax_proj.project_boxes(boxes, view, use_native=use_native)
            _same_lines(got, want)
        lines, types = want
        _same_lines(port_proj.postprocess_complete(lines, types),
                    jax_proj.postprocess_complete(lines, types))
        _same_lines(port_proj.postprocess_visible(lines, types),
                    jax_proj.postprocess_visible(lines, types))
        for use_native in (False, True):
            _same_lines(
                port_proj.remove_overlapping_lines(lines, types, use_native),
                jax_proj.remove_overlapping_lines(lines, types, use_native))
    assert port_proj.VIEWS == jax_proj.VIEWS
    assert port_factory.project_boxes is port_proj.project_boxes
    assert sorted(port_factory.__all__) == sorted(
        __import__("plankassembly_tpu.factory", fromlist=["x"]).__all__)


def test_helpers_equal_jax():
    line = np.array([[0.0, 0.1], [0.3, 0.1]])
    assert port_proj._seg_key(line) == jax_proj._seg_key(line)
    for a, b in (([[0, 0], [0, 2]], [[0, 0.5], [0, 1]]),
                 ([[0, 0], [2, 0]], [[1, 0], [3, 0]]),
                 ([[0, 0], [0, 2]], [[1, 0], [1, 1]])):
        a, b = np.array(a, float), np.array(b, float)
        assert port_proj._covers(a, b) == jax_proj._covers(a, b)
    chain = [np.array([[0.0, 0.0], [1.0, 0.0]]),
             np.array([[1.0, 0.0], [2.0, 0.0]]),
             np.array([[2.0, 0.0], [2.0, 1.0]])]
    got = port_proj.merge_degenerated_lines(chain)
    want = jax_proj.merge_degenerated_lines(chain)
    assert len(got) == len(want) == 2
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)
    assert port_proj.project_boxes(np.zeros((1, 6)), "f") == ([], [])
    assert port_proj.remove_overlapping_lines([], []) == ([], [])


def test_native_binding_equals_jax_and_numpy():
    """`node_classify` / `dedupe_covers` of the port's binding against the
    JAX binding on the same library, and against the numpy path."""
    if not port_native.available():
        pytest.skip("native/libplankgeom.so is not built "
                    "(python tools/build_native.py)")
    assert jax_native.available()
    for seed in SEEDS[::5]:
        boxes = _boxes(seed)
        for view in port_proj.VIEWS:
            segs, depths, _ = port_proj.box_view_segments(boxes, view)
            rects, near = port_proj._silhouettes(boxes, view)
            atomic, hidden = port_native.node_classify(segs, depths, rects,
                                                       near)
            ref_atomic, ref_hidden = jax_native.node_classify(
                segs, depths, rects, near)
            np.testing.assert_array_equal(atomic, ref_atomic)
            np.testing.assert_array_equal(hidden, ref_hidden)
            lines, types = port_proj.project_boxes(boxes, view,
                                                   use_native=False)
            np.testing.assert_array_equal(
                atomic, np.stack([l.reshape(4) for l in lines]))
            np.testing.assert_array_equal(hidden.astype(int), types)
            flat = np.stack([l.reshape(4) for l in lines])
            np.testing.assert_array_equal(
                port_native.dedupe_covers(flat, np.asarray(types)),
                jax_native.dedupe_covers(flat, np.asarray(types)))


def _jax_tools(root, gen, variants):
    """The JAX package's three tools, in this process, on `root`."""
    import generate_models as jgen
    import prepare_info as jprep
    import render_svgs as jrender

    jgen.main(argparse.Namespace(root=root, **gen))
    for variant in variants:
        ratio = (int(variant.rsplit("_", 1)[1]) / 100.0
                 if "noise_" in variant else None)
        os.makedirs(os.path.join(root, "data", variant, "svgs"))
        jrender.main(argparse.Namespace(
            root=root, data_type=variant, noise_ratio=ratio,
            noise_length=0.02, line_width=0.5, decimals=3, max_workers=1))
        os.makedirs(os.path.join(root, "data", variant, "infos"))
        jprep.main(argparse.Namespace(
            data_path=root, data_type=variant, name="", scale=1280.0,
            decimals=3, max_workers=1))


def _port_tools(root, gen_flags, variants, workers=1):
    generate_models.main(["--root", root, *gen_flags])
    for variant in variants:
        render_svgs.main(["--root", root, "--data_type", variant,
                          "--max_workers", str(workers)])
        prepare_info.main(["--data_path", root, "--data_type", variant,
                           "--max_workers", str(workers)])


def _files(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def test_tools_write_the_jax_tools_files(tmp_path):
    """Model JSONs, splits, SVGs (clean, visible, noisy and visible-noisy)
    and info JSONs byte for byte."""
    variants = ("complete", "visible", "noise_05", "visible_noise_05")
    _jax_tools(str(tmp_path / "jax"), dict(count=8, seed=4242,
                                           test_frac=0.5, valid_frac=0.25),
               variants)
    _port_tools(str(tmp_path / "port"), ["--count", "8", "--seed", "4242",
                                         "--test_frac", "0.5",
                                         "--valid_frac", "0.25"], variants)
    ours, ref = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert sorted(ours) == sorted(ref)
    assert len(ref) == 8 + 4 + 8 * 3 * 2 + 4 * 3 * 2 + 8 * 2 + 4 * 2
    for key in ref:
        assert ours[key] == ref[key], key
    # the noisy variants really are corrupted
    noisy = [v for k, v in ours.items() if "noise_05/svgs" in k]
    assert any(b'stroke="red"' in v or b'stroke="blue"' in v for v in noisy)


def test_render_fan_out_writes_the_serial_files(tmp_path):
    for workers, name in ((1, "serial"), (2, "pool")):
        _port_tools(str(tmp_path / name), ["--count", "6", "--seed", "77",
                                           "--test_frac", "1.0"],
                    ("noise_10",), workers=workers)
    serial, pool = _files(tmp_path / "serial"), _files(tmp_path / "pool")
    assert sorted(serial) == sorted(pool) and len(serial) == 6 + 4 + 18 + 6
    assert serial == pool


def test_tools_match_the_jax_golden(tmp_path):
    """The 64 serving seeds through the port's tools: every file's digest
    and the split files as the JAX tools wrote them
    (`fixtures/factory_jax_golden.json`, tests/make_torch_factory_golden.py)."""
    with open(os.path.join(FIXTURES, "factory_jax_golden.json")) as f:
        golden = json.load(f)
    root = str(tmp_path / "data")
    _port_tools(root, golden["generate_flags"], golden["variants"])
    digests = {}
    for rel, data in _files(root).items():
        if rel.startswith("splits"):
            assert data.decode() == golden["splits"][os.path.basename(rel)]
        else:
            digests[rel] = hashlib.sha256(data).hexdigest()
    assert digests == golden["sha256"]
    assert len(digests) == 64 + 4 * 64 * 4


def _fixture(name):
    with gzip.open(os.path.join(FIXTURES, name), "rt") as f:
        return json.load(f)


@pytest.mark.parametrize("fixture,seed", [("serve64.json.gz", 900000),
                                          ("train64.json.gz", 910000)])
def test_tools_regenerate_the_fixture_rows(tmp_path, fixture, seed):
    """The first rows of the serving and training fixtures, every field
    (the training fixture's `svgs` too)."""
    rows = _fixture(fixture)[:4]
    root = str(tmp_path / "data")
    _port_tools(root, ["--count", "4", "--seed", str(seed), "--test_frac",
                       "1.0"], ("complete",))
    for row in rows:
        with open(os.path.join(root, "data", "complete", "infos",
                               f"{row['name']}.json")) as f:
            info = json.load(f)
        assert {k: info[k] for k in row} == row
