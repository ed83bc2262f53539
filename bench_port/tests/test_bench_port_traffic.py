"""The traffic is fixed by the seed: the same seed gives the same
requests; other seeds the same set in another order. Each offline cell's
mix and limits as named, and its job cut into batches."""
from __future__ import annotations

import numpy as np
import pytest

from bench_port.harness import pool as P
from conftest import ROOT


def test_requests_fixed_by_seed():
    x = P.balanced_order(128, 1024, 7)
    assert np.array_equal(x, P.balanced_order(128, 1024, 7))
    y = P.balanced_order(128, 1024, 2 ** 32 + 3)
    assert not np.array_equal(x, y)
    assert np.array_equal(np.bincount(x), np.full(128, 8))
    assert np.array_equal(np.sort(x), np.sort(y))


def test_pool_requests():
    bodies = P.requests()
    assert len(bodies) == 128
    assert all(len(r["lines"]) == len(r["views"]) == len(r["types"])
               for r in bodies)


OFFLINE = {"complete.offline_b64": (64, 1024),
           "complete.offline_b512": (512, 1024),
           "complete.offline_b1": (1, 128)}


def _offline_driver():
    import os

    from bench_port.harness import cell
    return cell.load_file(os.path.join(ROOT, "bench_port", "drivers",
                                       "offline.py"), "test_offline_driver")


@pytest.mark.parametrize("workload", sorted(OFFLINE))
def test_offline_cells_traffic_and_limits(workload):
    """Each offline cell's mix and limits parse, as BENCHMARK.json names
    them: the batch and job of its name, and the limits the offline
    cells share."""
    from bench_port.harness import cell
    bench = cell.load_json(ROOT, "BENCHMARK.json")
    w = next(x for x in bench["workloads"] if x["name"] == workload)
    assert w["config"] == "gqa_complete_ep221" and w["chips"] == 1
    traffic = cell.load_json(ROOT, "bench_port", "traffic",
                             w["traffic"] + ".json")
    batch, job = OFFLINE[workload]
    assert traffic == {"kind": "offline", "batch": batch, "job": job}
    limits = cell.load_json(ROOT, "bench_port", "limits", workload + ".json")
    assert limits == {"max_gap": 0.6, "pack_mismatches": 0,
                      "answer_mismatches": 0, "pointer_faults": 0}


@pytest.mark.parametrize("workload", sorted(OFFLINE))
def test_offline_batches(workload):
    """A job's drawings sorted by their real tokens, cut into full batches
    of the cell's rows: 2 of 512 from 1024, 128 of 1 from 128, 16 of 64
    from 1024; every drawing of the job once."""
    from bench_port.harness import check as C
    from bench_port.harness.cell import load_json
    batch, job = OFFLINE[workload]
    conf = load_json(ROOT, "bench_port", "configs", "gqa_complete_ep221.json")
    pool = [int((~C.pack_request(b, conf)["input_mask"]).sum())
            for b in P.requests()]
    order = P.balanced_order(len(pool), job, 2 ** 31 + 5)
    real = [pool[i] for i in order]
    batches = _offline_driver().batches_of(real, batch)
    assert [len(b) for b in batches] == [batch] * (job // batch)
    flat = [i for b in batches for i in b]
    assert sorted(flat) == list(range(job))
    assert [real[i] for i in flat] == sorted(real)


def test_first_of_each_shape():
    first = _offline_driver().first_of_each_shape
    assert first([(64, 256), (64, 256), (64, 384), (64, 256), (32, 384)]) \
        == [0, 2, 4]
    assert first([(1, 1152)] * 5) == [0]
    assert first([]) == []
