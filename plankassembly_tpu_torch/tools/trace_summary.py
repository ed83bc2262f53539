"""Summarize a Chrome trace of `utils/profiling.trace_context` (the port's
counterpart of the JAX package's `tools/trace_summary.py`, which reads a
`jax.profiler` trace).

  python -m plankassembly_tpu_torch.tools.trace_summary <trace file or dir> \\
      [--top 30] [--filter NAME] [--gaps]

Lists the top device kernels (and memory copies and sets) by total time,
with their counts and their share of the summed kernel time. A trace
with no device activity (a CPU run) lists its host operators instead,
and says so. `--filter NAME`: only the events under an `annotate` range
whose name holds NAME (a kernel belongs to the range in which its launch
was made, on any thread of the process). `--gaps`: the busy time as the union of the events' intervals (not
their sum: kernels on several streams overlap), its share of the span
from the first event's start to the last one's end, and the largest idle
gaps with the events on either side. A directory means the newest
`*.json` or `*.json.gz` trace under it.
"""
from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CAT = "cpu_op"
ANNOTATION_CAT = "user_annotation"


def find_trace(path: str) -> str:
    if os.path.isfile(path):
        return path
    hits = [p for pattern in ("*.json", "*.json.gz") for p in glob.glob(
        os.path.join(path, "**", pattern), recursive=True)]
    if not hits:
        raise SystemExit(f"no *.json or *.json.gz trace under {path}")
    return max(hits, key=os.path.getmtime)


def load_events(path: str) -> list[dict]:
    """The complete ("X") events of a Chrome trace file."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def select(events: list[dict], name_filter: str | None = None
           ) -> tuple[list[dict], str]:
    """(the device events, "device"), or the host operators and "host"
    when the trace has no device event; with `name_filter`, only those
    made under an annotation whose name holds it."""
    chosen = [e for e in events if e.get("cat") in DEVICE_CATS]
    kind = "device"
    if not chosen:
        chosen = [e for e in events if e.get("cat") == HOST_CAT]
        kind = "host"
    if name_filter is None:
        return chosen, kind
    ranges = [(e["pid"], e["ts"], e["ts"] + e["dur"])
              for e in events if e.get("cat") == ANNOTATION_CAT
              and name_filter in e.get("name", "")]
    # a device event counts where its launch (the CUDA API call of the
    # same correlation id) was made; a host operator where it ran.
    # Any thread of the process: autograd runs a backward on a thread of
    # its own, inside the range the caller annotated.
    launch = {e["args"]["correlation"]: e for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}

    def origin(e):
        if kind == "host":
            return e
        return launch.get(e.get("args", {}).get("correlation"))

    def inside(e):
        o = origin(e)
        return o is not None and any(
            o["pid"] == pid and lo <= o["ts"] <= hi for pid, lo, hi in ranges)

    return [e for e in chosen if inside(e)], kind


def top_table(events: list[dict]) -> list[tuple[str, float, int, float]]:
    """(name, total us, count, share of the summed time) by total time."""
    total = collections.Counter()
    count = collections.Counter()
    for e in events:
        total[e["name"]] += e["dur"]
        count[e["name"]] += 1
    summed = sum(total.values()) or 1.0
    return [(name, us, count[name], us / summed)
            for name, us in total.most_common()]


def busy(events: list[dict]) -> tuple[float, float, list]:
    """(busy us: the union of the events' intervals, span us from the first
    start to the last end, gaps [(us, name before, name after)] largest
    first)."""
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events)
    if not spans:
        return 0.0, 0.0, []
    busy_us, gaps = 0.0, []
    start, end, last_name = spans[0]
    for s, t, name in spans[1:]:
        if s > end:
            busy_us += end - start
            gaps.append((s - end, last_name, name))
            start, end = s, t
        if t >= end:
            end, last_name = t, name
    busy_us += end - start
    return busy_us, end - spans[0][0], sorted(gaps, reverse=True)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m plankassembly_tpu_torch.tools.trace_summary",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("path", help="a trace file, or a directory holding one")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--filter", default=None,
                    help="only events under an annotate range whose name "
                         "holds this")
    ap.add_argument("--gaps", action="store_true",
                    help="busy share over the union of intervals and the "
                         "largest idle gaps")
    args = ap.parse_args(argv)

    path = find_trace(args.path)
    events, kind = select(load_events(path), args.filter)
    rows = top_table(events)
    print(f"trace: {path}")
    if kind == "host":
        print("no device events in the trace: host operators")
    under = f" under '{args.filter}'" if args.filter else ""
    print(f"{len(events)} {kind} events{under}, "
          f"{sum(r[1] for r in rows) / 1e3:.3f} ms summed\n")
    print(f"{'total ms':>10} {'count':>7} {'share':>6}  name")
    for name, us, n, share in rows[:args.top]:
        print(f"{us / 1e3:10.3f} {n:7d} {100 * share:5.1f}%  {name[:90]}")
    out = {"path": path, "kind": kind, "top": rows[:args.top]}
    if args.gaps:
        busy_us, span_us, gaps = busy(events)
        share = busy_us / span_us if span_us else 0.0
        print(f"\nspan {span_us / 1e3:.3f} ms, busy {busy_us / 1e3:.3f} ms "
              f"({100 * share:.1f}%, the union of intervals), idle "
              f"{100 * (1 - share):.1f}% over {len(gaps)} gaps")
        print(f"{'gap us':>10}  after -> before")
        for us, a, b in gaps[:15]:
            print(f"{us:10.1f}  {a[:40]} -> {b[:40]}")
        out.update(busy_us=busy_us, span_us=span_us, busy_share=share,
                   gaps=gaps)
    return out


if __name__ == "__main__":
    main()
