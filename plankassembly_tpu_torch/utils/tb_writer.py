"""TensorBoard event-file writer — no TensorFlow/TensorBoard dependency (a
copy of `plankassembly_tpu/utils/tb_writer.py`: the files of one package
read in the other).

The reference logs through Lightning's default TensorBoard logger
(`trainer_complete.py:69-70,87-89` `self.log(...)`), producing
`events.out.tfevents.*` files. The port's primary sink is JSONL
(greppable, diffable), but to match the reference's observability surface
this module emits real tfevents files that the TensorBoard UI can load.

The format is simple enough to hand-encode:

- a tfevents file is a sequence of TFRecords:
    uint64 LE payload length | uint32 LE masked-crc32c(length bytes)
    | payload | uint32 LE masked-crc32c(payload)
- each payload is a serialized `tensorflow.Event` protobuf; scalar points
  need only: wall_time (field 1, double), step (field 2, int64), summary
  (field 5) holding Summary.Value{tag (field 1), simple_value (field 2)};
- the first record is an Event with file_version (field 3) "brain.Event:2".

crc32c is the Castagnoli CRC (poly 0x82F63B78, reflected), with TFRecord's
rotate-and-add masking.
"""
from __future__ import annotations

import os
import socket
import struct
import time

# --- crc32c (Castagnoli, reflected, table-driven) --------------------------

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# --- minimal protobuf wire encoding ----------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        bits = n & 0x7F
        n >>= 7
        if n:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _double_field(field: int, value: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", value)


def _float_field(field: int, value: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", value)


def _varint_field(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(value)


def _bytes_field(field: int, value: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(value)) + value


def _scalar_event(wall_time: float, step: int, tag: str, value: float) -> bytes:
    summary_value = (_bytes_field(1, tag.encode("utf-8"))
                     + _float_field(2, float(value)))
    summary = _bytes_field(1, summary_value)
    return (_double_field(1, wall_time)
            + _varint_field(2, int(step))
            + _bytes_field(5, summary))


def _version_event(wall_time: float) -> bytes:
    return (_double_field(1, wall_time)
            + _bytes_field(3, b"brain.Event:2"))


class TensorBoardWriter:
    """Append scalar summaries to an `events.out.tfevents.*` file."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        now = time.time()
        host = socket.gethostname()
        self.path = os.path.join(
            log_dir, f"events.out.tfevents.{int(now)}.{host}")
        self._f = open(self.path, "ab")
        self._write_record(_version_event(now))

    def _write_record(self, payload: bytes):
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag: str, value: float, step: int,
                   wall_time: float | None = None):
        wall_time = time.time() if wall_time is None else wall_time
        self._write_record(_scalar_event(wall_time, step, tag, value))

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()


def read_tfevents(path: str) -> list[dict]:
    """Decode scalar events back out of a tfevents file (tests/tools only;
    TensorBoard itself is the real consumer). Verifies record CRCs."""
    events = []
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    while off < len(data):
        (length,) = struct.unpack_from("<Q", data, off)
        header = data[off:off + 8]
        (hcrc,) = struct.unpack_from("<I", data, off + 8)
        if hcrc != _masked_crc(header):
            raise ValueError(f"{path}: header crc mismatch at byte {off}")
        payload = data[off + 12:off + 12 + length]
        (pcrc,) = struct.unpack_from("<I", data, off + 12 + length)
        if pcrc != _masked_crc(payload):
            raise ValueError(f"{path}: payload crc mismatch at byte {off}")
        off += 12 + length + 4
        events.append(_decode_event(payload))
    return events


def _read_varint(buf: bytes, off: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[off]
        off += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, off
        shift += 7


def _decode_event(buf: bytes) -> dict:
    out: dict = {}
    off = 0
    while off < len(buf):
        key, off = _read_varint(buf, off)
        field, wire = key >> 3, key & 7
        if wire == 1:
            (val,) = struct.unpack_from("<d", buf, off)
            off += 8
            if field == 1:
                out["wall_time"] = val
        elif wire == 0:
            val, off = _read_varint(buf, off)
            if field == 2:
                out["step"] = val
        elif wire == 2:
            ln, off = _read_varint(buf, off)
            chunk = buf[off:off + ln]
            off += ln
            if field == 3:
                out["file_version"] = chunk.decode()
            elif field == 5:
                out.update(_decode_summary(chunk))
        elif wire == 5:
            off += 4
        else:  # pragma: no cover - no other wire types are emitted
            raise ValueError(f"unexpected wire type {wire}")
    return out


def _decode_summary(buf: bytes) -> dict:
    scalars = {}
    off = 0
    while off < len(buf):
        key, off = _read_varint(buf, off)
        field, wire = key >> 3, key & 7
        if field != 1 or wire != 2:
            raise ValueError(f"unexpected summary field {field}, wire {wire}")
        ln, off = _read_varint(buf, off)
        value_buf = buf[off:off + ln]
        off += ln
        tag, simple = None, None
        voff = 0
        while voff < len(value_buf):
            vkey, voff = _read_varint(value_buf, voff)
            vfield, vwire = vkey >> 3, vkey & 7
            if vwire == 2:
                vln, voff = _read_varint(value_buf, voff)
                chunk = value_buf[voff:voff + vln]
                voff += vln
                if vfield == 1:
                    tag = chunk.decode()
            elif vwire == 5:
                (val,) = struct.unpack_from("<f", value_buf, voff)
                voff += 4
                if vfield == 2:
                    simple = val
            elif vwire == 0:
                _, voff = _read_varint(value_buf, voff)
            else:  # pragma: no cover
                raise ValueError(f"unexpected wire type {vwire}")
        if tag is not None and simple is not None:
            scalars[tag] = simple
    return {"scalars": scalars} if scalars else {}
