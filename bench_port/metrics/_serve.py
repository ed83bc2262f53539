"""Shared readers of the serving cells' traces."""
from __future__ import annotations

from bench_port.metrics import _bounds as B
from bench_port.metrics._flops import program_flops


def roofline(ctx, name, bound_ms):
    """Share (%) of the device time inside the `name` ranges that the
    least time of their calls would take."""
    w = ctx.trace.window
    calls = ctx.trace.of(name) if w is not None else []
    device_ms = sum(r["device_ms"] for r in calls)
    if not calls or device_ms <= 0:
        return None
    return 100.0 * sum(bound_ms(ctx.dims, r["info"]) for r in calls) \
        / device_ms


def decode_bound(d, info):
    m = info["mask"]
    return B.decode_ms(d, int(m.shape[0]), int(m.shape[1]),
                       int((~m).sum()), info["steps"])


def encoder_bound(d, info):
    return B.encoder_ms(d, (~info["mask"]).sum(dim=1).tolist(),
                        info["streams"])


def mfu(ctx):
    """Model operations of every program finished in the window over the
    window and the bf16 peak (%)."""
    w = ctx.trace.window
    if w is None or w["busy_s"] <= 0 or not ctx.programs:
        return None
    ops = sum(program_flops(ctx.dims, n, s) for n, s in ctx.programs)
    return 100.0 * ops / (ctx.window_s * B.PEAK_BF16)


def idle(ctx):
    """Share (%) of the traced window in which no device activity ran."""
    w = ctx.trace.window
    if w is None or w["window_s"] <= 0 or w["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - w["busy_s"] / w["window_s"])

