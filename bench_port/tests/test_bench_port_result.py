"""Whole runs of each cell on the CPU at a tiny width: the last line has
exactly the contract's keys, and the traced run its device keys."""
from __future__ import annotations

import json

from bench_port.harness import cell
from conftest import run_tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]
DEVICE = {"platform", "kind", "count", "memory_peak_bytes"}


def test_last_line(tiny, capsys):
    result, checks, ctx = run_tiny(tiny, "complete.offline_b64")
    cell.emit(result, checks, ctx)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line) == KEYS
    assert set(line["device"]) == DEVICE
    assert line["correct"] is True and line["failed"] == 0
    assert "setup_s" in line["metrics"]
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    # each number compared, beside its limit, ends standard error
    tail = err.strip().splitlines()[-len(checks):]
    assert [t.split(":")[0] for t in tail] == [f"check {k}"
                                               for k, _, _ in checks]
    assert set(line["checks"]) == {k for k, _, _ in checks}


def test_traced_line(tiny):
    result, _, _ = run_tiny(tiny, "complete.offline_b64", trace=1)
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    # every per-layer metric of the cell but the set-up's parts (host
    # clock) reads the device's trace, and a reader that finds nothing
    # to read (no card here) leaves it out
    assert set(result["metrics"]) == {"setup.load_s", "setup.pack_s",
                                      "setup.warm_s"}
