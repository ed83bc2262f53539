"""setup.warm_s: seconds of set-up (host clock) from every drawing packed
to the first call of each shape of the job done and synchronised: a
checkout's first nvcc build, each shape's first encoder pass, decode plan
and graph. The three `setup.*` parts add up to `setup_s` (`_setup.py`).
None where the driver marks no parts."""

from bench_port.metrics._setup import parts


def read(ctx):
    return parts(ctx).get("warm")
