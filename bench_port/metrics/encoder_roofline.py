"""encoder_roofline: the least time of every `encode` call of the window (`_bounds.py`)
over the device time inside its ranges, in %."""

from bench_port.metrics._serve import encoder_bound, roofline


def read(ctx):
    return roofline(ctx, "encode", encoder_bound)
