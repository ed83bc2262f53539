"""programs_per_s: programs completed in the window over the window's time
(host clock): all the work and all the time of the window."""


def read(ctx):
    if ctx.programs is None or not ctx.window_s:
        return None
    return len(ctx.programs) / ctx.window_s
