"""The set-up's parts (`setup.load_s`, `setup.pack_s`, `setup.warm_s`):
None without the driver's marks, and adding up to `setup_s`, on a fake
context and in a whole run of each offline cell at a tiny width."""
from __future__ import annotations

import os
import types

import pytest

from bench_port.harness import cell
from conftest import ROOT, run_tiny

PARTS = ("setup.load_s", "setup.pack_s", "setup.warm_s")


def _reader(name):
    return cell.load_file(os.path.join(ROOT, "bench_port", "metrics",
                                       name + ".py"),
                          "test_metric_" + name.replace(".", "_"))


@pytest.mark.parametrize("name", PARTS)
def test_none_without_marks(name):
    read = _reader(name).read
    assert read(types.SimpleNamespace(marks={}, setup_s=12.5)) is None
    assert read(types.SimpleNamespace(marks={"load": 3.0, "pack": 4.5},
                                      setup_s=None)) is None


def test_parts_add_up_to_setup_s():
    ctx = types.SimpleNamespace(marks={"load": 3.25, "pack": 4.5},
                                setup_s=12.75)
    got = [_reader(n).read(ctx) for n in PARTS]
    assert got == [3.25, 1.25, 8.25]
    assert sum(got) == pytest.approx(ctx.setup_s, rel=1e-12)


@pytest.mark.parametrize("workload", ["complete.offline_b64",
                                      "complete.offline_b512",
                                      "complete.offline_b1",
                                      "visible.offline_b64"])
def test_run_marks_its_parts(tiny, workload):
    """The driver marks load and pack in order inside set-up, and the
    traced run reports the three parts, adding up to its `setup_s`."""
    result, _, ctx = run_tiny(tiny, workload, trace=1)
    assert list(ctx.marks) == ["load", "pack"]
    assert 0 < ctx.marks["load"] < ctx.marks["pack"] < ctx.setup_s
    parts = [result["metrics"][n]["value"] for n in PARTS]
    assert all(p > 0 for p in parts)
    assert sum(parts) == pytest.approx(ctx.setup_s, rel=1e-9)
    assert any(line.startswith("setup parts: load ")
               for line in cell.notes(ctx))
