"""mfu.serve: see `_serve.mfu`."""

from bench_port.metrics._serve import mfu


def read(ctx):
    return mfu(ctx)
