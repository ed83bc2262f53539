"""The traced run: ranges around the calls into each layer, set from the
harness's own files, and the profiler's device activity read in memory.

`wrap` puts a `torch.profiler.record_function` range around
a call and record the range on the host clock (its thread, start and
end, in the profiler's Unix-epoch nanoseconds) with facts about the call
(`info`). With the profiler running (`start`/`stop`), every device
activity (kernels, copies, sets) is attributed to the innermost range
open on the thread that launched it: the CUDA runtime call with the
same correlation id says which thread and when (a CUDA graph's kernels
share the correlation id of its launch). A range's device time is
the union of its activities' intervals, so it is the same whatever
kernels implement the layer. Each of the longest idle gaps is named by
the innermost of the program's spans (`utils.profiling.spans()`) open
at its middle, by the innermost range where no span is open, else
"outside any range". Nothing is written to disk.
"""
from __future__ import annotations

import collections
import functools
import threading
import time

from bench_port.metrics import _intervals as I

TOP = 10


def _program_spans(lo, hi) -> list:
    """The program's spans that lie within [lo, hi], on the clock of the
    profiler's timestamps; none from a program that records no spans."""
    from plankassembly_tpu_torch.utils import profiling
    if not hasattr(profiling, "spans"):
        return []
    return profiling.spans(lo, hi)


class Trace:
    def __init__(self, on: bool, device: str = "cuda"):
        self.on = on
        self.cuda = device == "cuda"
        self.active = False
        self.ranges: list[dict] = []
        self._prof = None
        self._restore = []
        self._lock = threading.Lock()
        self.window = None

    # -- ranges ---------------------------------------------------------
    def _wrapped(self, fn, name, info):
        import torch

        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not self.active:
                return fn(*args, **kwargs)
            t0 = time.time_ns()
            with torch.profiler.record_function(name):
                out = fn(*args, **kwargs)
            rec = {"name": name, "tid": threading.get_native_id(),
                   "t0": t0, "t1": time.time_ns()}
            if info is not None:
                rec["info"] = info(args, kwargs, out)
            with self._lock:
                self.ranges.append(rec)
            return out
        return call

    def wrap(self, obj, attr, name, info=None):
        """Range `name` around obj.attr (an attribute of an object or a
        module), for the rest of the run."""
        if not self.on:
            return
        fn = getattr(obj, attr)
        setattr(obj, attr, self._wrapped(fn, name, info))
        self._restore.append((obj, attr, fn))

    def restore(self):
        for obj, attr, fn in reversed(self._restore):
            setattr(obj, attr, fn)
        self._restore.clear()

    # -- profiler -------------------------------------------------------
    def start(self):
        if not self.on:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.cuda:
            torch.cuda.synchronize()
            activities.append(ProfilerActivity.CUDA)
        # every thread's CPU events, so that a launch from any thread of
        # the program finds the range open on that thread
        every_thread = torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
        self._prof = profile(activities=activities,
                             experimental_config=every_thread)
        self._prof.__enter__()
        self.active = True
        self._t0 = time.time_ns()

    def stop(self):
        if not self.on:
            return
        import torch
        if self.cuda:
            torch.cuda.synchronize()
        self._t1 = time.time_ns()
        self.active = False
        self._prof.__exit__(None, None, None)
        self.restore()
        self.window = self._digest(self._prof.profiler.kineto_results.events())
        self._prof = None

    def _digest(self, events):
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        names = {r["name"] for r in self.ranges}
        device, launch = [], {}
        for e in events:
            if e.device_type() == cuda:
                if e.name() in names:       # the ranges' own device spans
                    continue
                device.append(e)
            elif e.name().startswith(("cuda", "cu")):
                launch[e.correlation_id()] = e
        lo, hi = self._t0, self._t1
        spans = [(e.start_ns(), e.start_ns() + e.duration_ns())
                 for e in device]
        busy_ns = I.busy(spans, lo, hi)
        owners = self._owners(device, launch)
        for r in self.ranges:
            r["spans"] = []
        for r, sp in zip(owners, spans):
            if r is not None:
                r["spans"].append(sp)
        unattributed = sum(r is None for r in owners)
        for r in self.ranges:
            r["device_ms"] = I.busy(r.pop("spans")) / 1e6
            r["host_ms"] = (r["t1"] - r["t0"]) / 1e6
        ops = collections.Counter()
        for e, (a, b) in zip(device, spans):
            ops[e.name()] += (b - a) / 1e9
        gaps = sorted(I.gaps(spans, lo, hi), key=lambda g: g[0] - g[1])
        program = _program_spans(lo, hi)
        idle = [[self._open_at((a + b) / 2, program), (b - a) / 1e9]
                for a, b in gaps[:TOP]]
        return {"window_s": (hi - lo) / 1e9, "busy_s": busy_ns / 1e9,
                "device_events": len(device), "unattributed": unattributed,
                "device_ops": [[n, s] for n, s in ops.most_common(TOP)],
                "idle_gaps": idle}

    def _owners(self, device, launch):
        """For each device activity, the innermost range open on the
        launching thread when its runtime call was made (None if none):
        one sweep a thread over range ends and launches in time order."""
        owners = [None] * len(device)
        marks = collections.defaultdict(list)
        for r in self.ranges:
            marks[r["tid"]] += [(r["t0"], 0, r), (r["t1"], 2, r)]
        for i, e in enumerate(device):
            rt = launch.get(e.correlation_id())
            if rt is not None:
                # a CPU event's resource id is its thread's native id
                marks[rt.device_resource_id()].append((rt.start_ns(), 1, i))
        for items in marks.values():
            items.sort(key=lambda m: (m[0], m[1]))
            stack = []
            for _, kind, x in items:
                if kind == 0:
                    stack.append(x)
                elif kind == 2:
                    stack.remove(x)
                elif stack:
                    owners[x] = stack[-1]
        return owners

    def _open_at(self, t, program=()) -> str:
        """The innermost of the program's spans (`program`) open on any
        thread at time t; where none is, the innermost range."""
        inside = [(s.t1 - s.t0, s.name) for s in program
                  if s.t0 <= t <= s.t1]
        if not inside:
            inside = [(r["t1"] - r["t0"], r["name"]) for r in self.ranges
                      if r["t0"] <= t <= r["t1"]]
        if not inside:
            return "outside any range"
        return min(inside)[1]

    def of(self, name: str) -> list[dict]:
        return [r for r in self.ranges if r["name"] == name]
