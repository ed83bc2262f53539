"""setup_s: process start to the first timed request or step (host clock):
loading, packing, warming up every shape the cell's traffic uses."""


def read(ctx):
    return ctx.setup_s
