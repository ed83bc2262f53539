"""`correct` fails where it must: the float8 control put in the program's
place comes out not correct, and so does a run whose timed path alters a
token or an answer where it is produced."""
from __future__ import annotations

import numpy as np
import pytest

from conftest import run_tiny


@pytest.mark.parametrize("seed", [2 ** 31 + 1, 2 ** 32 + 7, 12345])
def test_float8_control_is_not_correct(sharp, seed):
    """The float8 reference in the program's place, judged against the
    cell's own limits, comes out not correct; the program correct."""
    result, checks, ctx = run_tiny(sharp, "complete.offline_b64",
                                   control=True, seed=seed)
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


@pytest.mark.parametrize("fault", [_alter_token, _alter_answer])
def test_fault_is_not_correct(tiny, fault, monkeypatch):
    fault(monkeypatch)
    result, _, _ = run_tiny(tiny, "complete.offline_b64")
    assert result["correct"] is False


@pytest.mark.card
def test_offline_cell_on_the_card(card):
    """The real cell, a short window: the program correct on the card and
    the float8 control not."""
    import argparse
    import time

    from bench_port.harness import cell
    args = argparse.Namespace(workload="complete.offline_b64",
                              seed=2 ** 31 + 99, seconds=2.0, trace=0)
    result, _, ctx = cell.run(args, time.monotonic(), control=True)
    assert all(v <= lim for _, v, lim in ctx.checks)
    assert result["correct"] is False
