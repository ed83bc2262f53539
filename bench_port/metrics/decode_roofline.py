"""decode_roofline: the least time of every `decode_from_memory` call of the window (`_bounds.py`)
over the device time inside its ranges, in %."""

from bench_port.metrics._serve import decode_bound, roofline


def read(ctx):
    return roofline(ctx, "decode_from_memory", decode_bound)
