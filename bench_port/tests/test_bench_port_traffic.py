"""The traffic is fixed by the seed: the same seed gives the same
requests; other seeds the same set in another order. A configuration's
pool, the visible-lines pool and its script. Each offline cell's mix and
limits as named, and its job cut into batches."""
from __future__ import annotations

import gzip
import hashlib
import json
import os

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


def _config(name):
    from bench_port.harness.cell import load_json
    return load_json(ROOT, "bench_port", "configs", name + ".json")


NAMES = [f"syn{s}" for s in (*range(900000, 900064),
                             *range(910000, 910064))]


@pytest.mark.parametrize("config", ["gqa_complete_ep221", "gqa_visible_ep79"])
def test_pool_requests(config):
    bodies = P.requests(_config(config))
    assert [r["name"] for r in bodies] == NAMES
    assert all(len(r["lines"]) == len(r["views"]) == len(r["types"])
               for r in bodies)


# sha256 of the requests each complete cell sends for seed 2**31 + 5 (a
# job's pool indices from `balanced_order`, as compact sorted-key JSON),
# taken before configurations could name a pool
COMPLETE_DIGESTS = {
    1024: "a9dff3554d3576498c533701696601072ad0a8d0a2796345441f54624c1abb2e",
    128: "0a8bce226d35fc0ce1d5017327143db2df986a8a38688881936a145d0537a87f"}


@pytest.mark.parametrize("job", sorted(COMPLETE_DIGESTS))
def test_complete_requests_unchanged(job):
    """A configuration without "pool" sends the requests it always sent."""
    conf = _config("gqa_complete_ep221")
    assert "pool" not in conf
    bodies = P.requests(conf)
    assert bodies == P.requests()
    sent = [bodies[i] for i in P.balanced_order(len(bodies), job, 2 ** 31 + 5)]
    blob = json.dumps(sent, sort_keys=True, separators=(",", ":")).encode()
    assert hashlib.sha256(blob).hexdigest() == COMPLETE_DIGESTS[job]


def test_visible_pool():
    """Visible lines only, every drawing within the visible model's
    MAX_INPUT_LENGTH (560), and the serve half's packed real lengths
    those of the program's visible golden, by name."""
    from bench_port.harness import check as C
    conf = _config("gqa_visible_ep79")
    assert P.files(conf) == ["visible_serve64.json.gz",
                             "visible_train64.json.gz"]
    bodies = P.requests(conf)
    assert [r["name"] for r in bodies] == NAMES
    assert all(t == 0 for r in bodies for t in r["types"])
    real = {r["name"]: int((~C.pack_request(r, conf)["input_mask"]).sum())
            for r in bodies}
    assert conf["DATA"]["MAX_INPUT_LENGTH"] == 560
    assert max(real.values()) < 560
    golden = np.load(os.path.join(ROOT, "plankassembly_tpu_torch",
                                  "fixtures",
                                  "serve64_visible_jax_golden.npz"))
    want = dict(zip(golden["names"].tolist(),
                    golden["input_lengths"].tolist()))
    assert len(want) == 64
    assert {n: real[n] for n in want} == want
    # the complete pool's drawings of the same cabinets are longer
    complete = {r["name"]: len(r["lines"]) for r in P.requests()}
    assert all(len(r["lines"]) <= complete[r["name"]] for r in bodies)


def test_make_visible_pool_rebuilds_the_files():
    from bench_port.harness.cell import load_file
    script = load_file(os.path.join(ROOT, "bench_port", "data",
                                    "make_visible_pool.py"),
                       "test_make_visible_pool")
    built = script.build()
    assert sorted(built) == sorted(P.files({"pool": "visible"}))
    for name, blob in built.items():
        with open(os.path.join(P.DATA, name), "rb") as f:
            assert f.read() == blob, name
        assert json.loads(gzip.decompress(blob))[0]["name"] in NAMES


# each offline cell: its configuration, rows a call, drawings a job, and
# its `max_gap` limit (the exact counts are 0 in every cell)
OFFLINE = {"complete.offline_b64": ("gqa_complete_ep221", 64, 1024, 0.6),
           "complete.offline_b512": ("gqa_complete_ep221", 512, 1024, 0.6),
           "complete.offline_b1": ("gqa_complete_ep221", 1, 128, 0.6),
           "visible.offline_b64": ("gqa_visible_ep79", 64, 1024, 0.6)}


def _offline_driver():
    import os

    from bench_port.harness import cell
    return cell.load_file(os.path.join(ROOT, "bench_port", "drivers",
                                       "offline.py"), "test_offline_driver")


@pytest.mark.parametrize("workload", sorted(OFFLINE))
def test_offline_cells_traffic_and_limits(workload):
    """Each offline cell's mix and limits parse, as BENCHMARK.json names
    them: the configuration, batch and job of its name, and its
    limits."""
    from bench_port.harness import cell
    bench = cell.load_json(ROOT, "BENCHMARK.json")
    w = next(x for x in bench["workloads"] if x["name"] == workload)
    config, batch, job, max_gap = OFFLINE[workload]
    assert w["config"] == config and w["chips"] == 1
    traffic = cell.load_json(ROOT, "bench_port", "traffic",
                             w["traffic"] + ".json")
    assert traffic == {"kind": "offline", "batch": batch, "job": job}
    limits = cell.load_json(ROOT, "bench_port", "limits", workload + ".json")
    assert limits == {"max_gap": max_gap, "pack_mismatches": 0,
                      "answer_mismatches": 0, "pointer_faults": 0}


@pytest.mark.parametrize("workload", sorted(OFFLINE))
def test_offline_batches(workload):
    """A job's drawings sorted by their real tokens, cut into full batches
    of the cell's rows: 2 of 512 from 1024, 128 of 1 from 128, 16 of 64
    from 1024; every drawing of the job once."""
    from bench_port.harness import check as C
    config, batch, job, _ = OFFLINE[workload]
    conf = _config(config)
    pool = [int((~C.pack_request(b, conf)["input_mask"]).sum())
            for b in P.requests(conf)]
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
