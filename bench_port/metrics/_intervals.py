"""Union of device intervals, and the idle gaps between them.

The union, not the sum (`chip_smoke.py::decode_idle_share`, copied): with
programmatic dependent launch a kernel starts before the previous one
ends, and kernels on two streams overlap.
"""
from __future__ import annotations


def merge(spans):
    """Sorted, disjoint (start, end) intervals covering `spans`."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy(spans, lo=None, hi=None) -> float:
    """Length of the union of `spans`, clipped to [lo, hi] when given."""
    total = 0.0
    for a, b in merge(spans):
        if lo is not None:
            a = max(a, lo)
        if hi is not None:
            b = min(b, hi)
        total += max(0.0, b - a)
    return total


def gaps(spans, lo, hi):
    """(start, end) of each stretch of [lo, hi] that no span covers."""
    out, t = [], lo
    for a, b in merge(spans):
        if b <= lo or a >= hi:
            continue
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if t < hi:
        out.append((t, hi))
    return out
