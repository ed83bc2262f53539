"""The port's `utils/` (`tb_writer.py`, `profiling.py`) and the trainer's
TensorBoard stream, against the JAX package's."""
import glob
import json
import os

import torch

from plankassembly_tpu.utils import tb_writer as jax_tb
from plankassembly_tpu_torch.train.loop import MetricsLogger
from plankassembly_tpu_torch.utils import tb_writer as port_tb
from plankassembly_tpu_torch.utils.profiling import annotate, trace_context


def test_crc32c_known_vector():
    # RFC 3720 / the standard Castagnoli test vector
    assert port_tb.crc32c(b"123456789") == 0xE3069283
    assert port_tb.crc32c(b"") == 0
    for data in (b"a", b"plank" * 37, bytes(range(256))):
        assert port_tb.crc32c(data) == jax_tb.crc32c(data)


def _write(mod, log_dir):
    w = mod.TensorBoardWriter(log_dir)
    w.add_scalar("train/loss", 3.25, step=10, wall_time=1000.5)
    w.add_scalar("train/accuracy", 0.5, step=10, wall_time=1000.5)
    w.add_scalar("val/fmeasure", 0.938, step=200, wall_time=1001.0)
    w.close()
    return w.path


def test_tfevents_read_across_packages(tmp_path):
    """A file written by either package reads back in the other, CRCs
    checked; the scalar records are the same bytes."""
    ours = _write(port_tb, str(tmp_path / "port"))
    ref = _write(jax_tb, str(tmp_path / "jax"))
    for path in (ours, ref):
        a, b = port_tb.read_tfevents(path), jax_tb.read_tfevents(path)
        assert a == b
        assert a[0]["file_version"] == "brain.Event:2"
        scalars = {(e["step"], tag): v for e in a
                   for tag, v in e.get("scalars", {}).items()}
        assert scalars[(10, "train/loss")] == 3.25
        assert abs(scalars[(200, "val/fmeasure")] - 0.938) < 1e-6
    # past the version record (its wall time is the clock's), equal bytes
    with open(ours, "rb") as f, open(ref, "rb") as g:
        assert f.read()[40:] == g.read()[40:]


def test_tfevents_reader_rejects_a_corrupt_record(tmp_path):
    path = _write(port_tb, str(tmp_path))
    data = bytearray(open(path, "rb").read())
    data[-3] ^= 0xFF
    open(path, "wb").write(bytes(data))
    try:
        port_tb.read_tfevents(path)
    except ValueError as exc:
        assert "crc mismatch" in str(exc)
    else:
        raise AssertionError("a corrupt record was read")


def test_trainer_logger_writes_both_streams(tmp_path):
    """MetricsLogger's JSONL records and tfevents scalars agree (the epoch
    stays out of TensorBoard, as in JAX's logger); close() closes both."""
    logger = MetricsLogger(str(tmp_path))
    logger.log(1, {"epoch": 0, "train/loss": 6.25, "train/accuracy": 0.125})
    logger.log(2, {"epoch": 0, "train/loss": 5.5, "train/steps_per_sec": 3.5})
    logger.log(2, {"val/precision": 0.75, "val/recall": 0.5,
                   "val/fmeasure": 0.6})
    logger.close()
    logger.log(3, {"train/loss": 1.0})  # after close: nothing written
    with open(tmp_path / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    jsonl = {(r["step"], k): v for r in recs for k, v in r.items()
             if k not in ("step", "time", "epoch")}
    (path,) = glob.glob(os.path.join(tmp_path, "events.out.tfevents.*"))
    events = jax_tb.read_tfevents(path)
    tb = {(e["step"], k): v for e in events
          for k, v in e.get("scalars", {}).items()}
    assert sorted(tb) == sorted(jsonl) and len(tb) == 7
    for key, value in jsonl.items():
        assert tb[key] == torch.tensor(value, dtype=torch.float32).item()
    assert sum(1 for e in events if "wall_time" in e) == len(events)


def test_trace_context_and_annotate(tmp_path):
    with trace_context(str(tmp_path)) as prof:
        with annotate("plank-region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    (trace,) = glob.glob(os.path.join(tmp_path, "trace_*.json"))
    with open(trace) as f:
        assert "plank-region" in f.read()
    with trace_context(str(tmp_path / "off"), enabled=False) as prof:
        pass
    assert prof is None and not os.path.exists(tmp_path / "off")
