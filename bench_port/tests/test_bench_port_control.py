"""`correct` fails where it must: the float8 control put in the program's
place comes out not correct, and so does a run whose timed path alters a
token or an answer where it is produced."""
from __future__ import annotations

import numpy as np
import pytest

from conftest import run_tiny


CELLS = ["complete.offline_b64", "complete.offline_b512",
         "complete.offline_b1", "visible.offline_b64"]


@pytest.mark.parametrize("workload,seed,seconds", [
    ("complete.offline_b64", 2 ** 31 + 1, 1.0),
    ("complete.offline_b64", 2 ** 32 + 7, 1.0),
    ("complete.offline_b64", 12345, 1.0),
    ("complete.offline_b512", 2 ** 31 + 3, 1.0),
    # one drawing a call: a window long enough for some tens of programs
    ("complete.offline_b1", 2 ** 32 + 11, 8.0),
    ("visible.offline_b64", 2 ** 31 + 13, 1.0)])
def test_float8_control_is_not_correct(sharp, workload, seed, seconds):
    """The float8 reference in the program's place, judged against the
    cell's own limits, comes out not correct; the program correct."""
    result, checks, ctx = run_tiny(sharp, workload, control=True, seed=seed,
                                   seconds=seconds)
    assert all(v <= lim for _, v, lim in ctx.checks)
    assert result["correct"] is False
    assert dict((k, v) for k, v, _ in checks)["max_gap"] > \
        3 * ctx.readings["max_gap"]


def _alter_token(monkeypatch):
    from plankassembly_tpu_torch import decode
    greedy = decode.greedy_decode

    def broken(*args, **kwargs):
        out = greedy(*args, **kwargs)
        s = out["samples"].clone()
        s[:, 1] = (s[:, 1] + 1) % 512        # the bbox's second coordinate
        return {**out, "samples": s}
    monkeypatch.setattr(decode, "greedy_decode", broken)


def _alter_answer(monkeypatch):
    from plankassembly_tpu_torch import serving
    post = serving.postprocess_prediction

    def broken(sample_row, attach_row, dims):
        pred, attach = post(sample_row, attach_row, dims)
        return np.asarray(pred)[:, ::-1], attach
    monkeypatch.setattr(serving, "postprocess_prediction", broken)


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", [_alter_token, _alter_answer])
def test_fault_is_not_correct(tiny, fault, workload, monkeypatch):
    fault(monkeypatch)
    result, _, _ = run_tiny(tiny, workload)
    assert result["correct"] is False


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_offline_cell_on_the_card(card, workload):
    """The real cell, a 10 s window (every drawing of the pool served, at
    B=1 too): the program correct on the card and the float8 control
    not."""
    import argparse
    import time

    from bench_port.harness import cell
    args = argparse.Namespace(workload=workload, seed=2 ** 31 + 99,
                              seconds=10.0, trace=0)
    result, _, ctx = cell.run(args, time.monotonic(), control=True)
    assert all(v <= lim for _, v, lim in ctx.checks)
    assert result["correct"] is False
