"""Set-up cut into its parts at the driver's marks (`Ctx.mark`). Each part
runs from the mark before it (the process's start for the first) to its
own, and the last, `warm`, from the last mark to the end of set-up: so
the parts add up to `setup_s`, read from the same clock readings."""
from __future__ import annotations


def parts(ctx) -> dict:
    """{part: seconds} in the order the marks were taken; {} where the
    driver took no mark or set-up did not end."""
    if not ctx.marks or ctx.setup_s is None:
        return {}
    out, t = {}, 0.0
    for name, at in ctx.marks.items():
        out[name], t = at - t, at
    out["warm"] = ctx.setup_s - t
    return out
