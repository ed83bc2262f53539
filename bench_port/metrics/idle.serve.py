"""idle.serve: see `_serve.idle`."""

from bench_port.metrics._serve import idle


def read(ctx):
    return idle(ctx)
