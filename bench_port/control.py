"""Readings that set the limits of `correct`: the program's and the float8
control's, over many seeds in one process.

  python3 bench_port/control.py --workload NAME --seeds 1,2,3 --seconds 40

For each seed it runs the cell (set-up, the window at the cell's own
load, the judgement) with the float8 reference put in the program's
place as well, and prints one JSON line: the program's readings and
`correct` (the lower end of each limit), and the control's readings and
`correct` (the upper end), which has to be false.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from bench_port.harness import cell  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        run = argparse.Namespace(workload=args.workload, seed=seed,
                                 seconds=args.seconds, trace=0)
        result, checks, ctx = cell.run(run, time.monotonic(), control=True)
        print(json.dumps({
            "seed": seed, "readings": ctx.readings,
            "correct": all(v <= lim for _, v, lim in ctx.checks),
            "control": {k: v for k, v, _ in checks},
            "control_correct": result["correct"],
            "metrics": result["metrics"]}), flush=True)


if __name__ == "__main__":
    main()
