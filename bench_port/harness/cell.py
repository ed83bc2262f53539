"""One run of one cell: find its files by name, drive it, judge it, read
its metrics, and print the result.

Everything a cell needs is found by the names in BENCHMARK.json:
- bench_port/configs/<config>.json: the checkpoint, its hparams file, the
  MODEL / DATA / TOKEN sections as run (the reference reads these),
  `reduced` and `assumed`;
- bench_port/traffic/<traffic>.json: the mix's parameters and its
  `kind`, which names the driver bench_port/drivers/<kind>.py;
- bench_port/limits/<workload>.json: the limit of each number compared;
- bench_port/metrics/<metric>.py: a `read(ctx)` for each metric, which
  returns the value or None where it finds nothing to read.
"""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time

from bench_port.harness import check as C
from bench_port.harness.trace import Trace
from bench_port.metrics._setup import parts as setup_parts

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "plankassembly_tpu")


class NoDevice(RuntimeError):
    pass


class NoProgram(RuntimeError):
    pass


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_file(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Ctx:
    """What a driver fills in and the metric readers read."""

    def __init__(self, args, config, traffic, device, t_start):
        self.config, self.traffic = config, traffic
        self.device, self.t_start = device, t_start
        self.seed, self.seconds = args.seed, args.seconds
        self.trace = Trace(bool(args.trace), device)
        self.setup_s = None
        self.marks = {}          # set-up's parts: seconds since start
        self.routes = None       # the decode routes the run took
        self.window_s = None
        self.memory_peak = 0
        self.attempted = self.failed = 0
        self.programs = None     # (real input tokens, served steps) each
        self.items = []          # the sample the reference judges
        from bench_port.metrics._flops import dims_of
        self.dims = dims_of(config)

    def path(self, rel: str) -> str:
        return os.path.join(ROOT, rel)

    def sync(self):
        if self.device == "cuda":
            import torch
            torch.cuda.synchronize()

    def mark(self, name: str):
        """End of a part of set-up (`setup.*` metrics), device work done."""
        self.sync()
        self.marks[name] = time.monotonic() - self.t_start

    def mark_setup(self):
        self.sync()
        self.setup_s = time.monotonic() - self.t_start
        if self.device == "cuda":
            import torch
            torch.cuda.reset_peak_memory_stats()

    def read_memory_peak(self):
        if self.device == "cuda":
            import torch
            torch.cuda.synchronize()
            self.memory_peak = int(torch.cuda.max_memory_allocated())

    def check_program_config(self, cfg):
        """The program runs the configuration file's model: its hparams
        agree with the MODEL / DATA / TOKEN sections the reference reads."""
        got = {s: {k: getattr(getattr(cfg, s), k) for k in self.config[s]}
               for s in ("MODEL", "DATA", "TOKEN")}
        want = {s: self.config[s] for s in ("MODEL", "DATA", "TOKEN")}
        if got != want:
            raise RuntimeError(f"the program's configuration {got} is not "
                               f"the configuration file's {want}")


def metric_names(bench, cell_name, trace: bool) -> list[dict]:
    """The cell's metrics of this run: per-layer with --trace 1, else
    end-to-end. A metric without `workloads` belongs to every cell that
    reports what it moves (per-layer) or to every cell (end-to-end)."""
    e2e = [m for m in bench["end_to_end"]
           if cell_name in m.get("workloads", [cell_name])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def read_metrics(ctx, specs) -> dict:
    out = {}
    for m in specs:
        mod = load_file(os.path.join(HERE, "metrics", m["name"] + ".py"),
                        "bench_port_metric_" + m["name"].replace(".", "_"))
        v = mod.read(ctx)
        if v is not None:                   # None: nothing to read
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def run(args, t_start, device=None, control=False, override=None):
    """Run the cell named by args.workload. Returns (result, checks, ctx):
    checks lists (name, reading, limit). `device` "cpu" runs the program's
    plain versions without looking for a card, and `override` replaces
    keys of the cell's "config" / "traffic" files (the benchmark's tests,
    at a tiny size). With `control` the float8 reference takes the
    program's place in the judgement: `correct` and the checks are the
    control's, and the program's stay in ctx.readings and ctx.checks."""
    bench = load_json(ROOT, "BENCHMARK.json")
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload),
                None)
    if cell is None:
        raise SystemExit(f"no workload {args.workload!r} in BENCHMARK.json")
    config = load_json(HERE, "configs", cell["config"] + ".json")
    traffic = load_json(HERE, "traffic", cell["traffic"] + ".json")
    limits = load_json(HERE, "limits", cell["name"] + ".json")
    override = override or {}
    config = {**config, **override.get("config", {})}
    traffic = {**traffic, **override.get("traffic", {})}
    try:
        import plankassembly_tpu_torch  # noqa: F401
    except ImportError as e:
        raise NoProgram(f"the program is not in this checkout ({e})")
    import torch
    if device is None:
        if not torch.cuda.is_available():
            raise NoDevice("no CUDA device")
        if torch.cuda.device_count() < cell["chips"]:
            raise NoDevice(f"{torch.cuda.device_count()} CUDA devices; the "
                           f"cell needs {cell['chips']}")
        device = "cuda"
    ctx = Ctx(args, config, traffic, device, t_start)
    driver = load_file(os.path.join(HERE, "drivers", traffic["kind"] + ".py"),
                       "bench_port_driver_" + traffic["kind"])
    driver.run(ctx)
    if device == "cuda":
        torch.cuda.empty_cache()
    readings, ctl = C.judge(ctx.items, config, ROOT, device, control=control)
    ctx.readings, ctx.checks = readings, C.verdict(readings, limits)
    checks = C.verdict(ctl, limits) if control else ctx.checks
    metrics = read_metrics(ctx, metric_names(bench, cell["name"],
                                             bool(args.trace)))
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda"
           else "cpu", "count": cell["chips"],
           "memory_peak_bytes": ctx.memory_peak}
    result = {"correct": bool(ctx.items) and ctx.failed == 0
              and all(v <= lim for _, v, lim in checks),
              "attempted": ctx.attempted, "failed": ctx.failed,
              "metrics": metrics, "device": dev}
    if args.trace and ctx.trace.window is not None:
        w = ctx.trace.window
        dev["busy_s"], dev["window_s"] = w["busy_s"], w["window_s"]
        result["breakdown"] = {"device_ops": w["device_ops"],
                               "idle_gaps": w["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in checks}
    return result, checks, ctx


def emit(result, checks, ctx=None):
    """Numbers compared, each beside its limit, as the last lines on
    standard error; the result as the last line on standard output."""
    if ctx is not None:
        for line in notes(ctx):
            print(line, file=sys.stderr)
    for k, v, lim in checks:
        print(f"check {k}: {v} (limit {lim})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def notes(ctx) -> list[str]:
    """Earlier stderr lines: the window, the trace's coverage, the card's
    name and power limit."""
    out = [f"window {ctx.window_s} s, setup {ctx.setup_s} s, "
           f"{ctx.attempted} attempted, {ctx.failed} failed, "
           f"{ctx.readings.get('tokens')} tokens judged"]
    parts = setup_parts(ctx)
    if parts:
        out.append("setup parts: " + ", ".join(
            f"{k} {v} s" for k, v in parts.items())
            + f"; their sum {sum(parts.values())} s")
    if ctx.routes is not None:
        out.append(f"routes: {json.dumps(ctx.routes)}")
    w = ctx.trace.window
    if w is not None:
        out.append(f"trace: {w['device_events']} device activities, "
                   f"{w['unattributed']} outside any range")
    if ctx.device == "cuda":
        try:
            card = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=20).stdout.strip()
        except (OSError, subprocess.SubprocessError) as e:
            card = f"nvidia-smi failed: {e}"
        out.append(f"card: {card}")
    return out

