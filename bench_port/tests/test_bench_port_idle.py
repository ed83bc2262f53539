"""Idle gaps named by the program's innermost span open at their middle,
by the harness's innermost range where no span is open, else "outside
any range"."""
from __future__ import annotations

from bench_port.harness.trace import Trace


def _span(name, t0, t1):
    from plankassembly_tpu_torch.utils.profiling import Span
    return Span(name, 0, None, 0, 1, t0, t1, None)


def test_gap_named_by_innermost_span_then_range():
    tr = Trace(True, "cpu")
    tr.ranges = [{"name": "encode", "tid": 1, "t0": 100, "t1": 200},
                 {"name": "decode_from_memory", "tid": 1, "t0": 200,
                  "t1": 900}]
    program = [_span("greedy_decode", 100, 1000),
               _span("persistent.graph_build", 300, 400),
               _span("gc", 350, 360)]
    assert tr._open_at(355, program) == "gc"
    assert tr._open_at(320, program) == "persistent.graph_build"
    assert tr._open_at(500, program) == "greedy_decode"
    assert tr._open_at(150, []) == "encode"         # no program span open
    assert tr._open_at(1500, program) == "outside any range"
    assert tr._open_at(500) == "decode_from_memory"
