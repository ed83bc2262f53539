"""Benchmark of plankassembly_tpu_torch: run one cell once.

  python3 bench_port/run.py --workload NAME --seed N --seconds S --trace 0|1

Finds the cell in BENCHMARK.json, its configuration in
bench_port/configs/<config>.json and its traffic in
bench_port/traffic/<traffic>.json, whose "kind" names the driver in
bench_port/drivers/<kind>.py. The driver loads and warms up the program,
measures for --seconds, and judges what the timed path produced against
the plain reference (bench_port/reference/). Each metric the cell
reports is read by bench_port/metrics/<metric>.py: the end-to-end ones
with --trace 0, the per-layer ones with --trace 1 (a run under the
profiler). The last line of standard output is the result's JSON.
"""
from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
# caches of the program and of the libraries it may load stay inside the
# checkout, at fixed paths; transformers must not load JAX
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      os.path.join(ROOT, "build", "torch_extensions"))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from bench_port.harness import cell
    try:
        result, checks, ctx = cell.run(args, t_start=T_START)
    except cell.NoDevice as e:
        print(f"bench_port: {e}", file=sys.stderr)
        return 2
    except cell.NoProgram as e:
        print(f"bench_port: {e}", file=sys.stderr)
        return 3
    found = cell.forbidden_modules()
    if found:
        print("bench_port: modules of JAX or the JAX package are loaded: "
              + ", ".join(found), file=sys.stderr)
        return 4
    cell.emit(result, checks, ctx)
    return 0


if __name__ == "__main__":
    sys.exit(main())
