"""setup.load_s: seconds of set-up (host clock) from the process's start to
the checkpoint loaded and on the device: the interpreter, PyTorch and the
program imported, the weights read and copied. The three `setup.*` parts
add up to `setup_s` (`_setup.py`). None where the driver marks no parts."""

from bench_port.metrics._setup import parts


def read(ctx):
    return parts(ctx).get("load")
