"""setup.pack_s: seconds of set-up (host clock) from the checkpoint loaded
to every drawing of the job packed and batched (`serving.pack_info_dict`,
the sort by length, the host batches). The three `setup.*` parts add up
to `setup_s` (`_setup.py`). None where the driver marks no parts."""

from bench_port.metrics._setup import parts


def read(ctx):
    return parts(ctx).get("pack")
