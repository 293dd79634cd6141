"""First-party TensorBoard event-file writer and reader (no TensorFlow).

Counterpart of `cape_tpu.train.tb_events` (copied; numpy, `struct` and
`socket` only): the same records, so that either package reads the
other's files. The reference's only training observability surface is
TensorBoard (reference lib/models.py:399-414 scalar summaries, :917-922
validation summary + FileWriter); a user migrating from it expects
`tensorboard --logdir results/` to work, so the Trainer also writes event
files beside metrics.jsonl.

It hand-encodes the two formats TensorBoard reads:

* the TFRecord framing — `<u64 length><masked crc32c(length)><payload>
  <masked crc32c(payload)>` per record, CRC32C = Castagnoli (reflected
  poly 0x82F63B78), mask = rotl17(crc) + 0xA282EAD8;
* the `Event` protobuf — wall_time(1:double), step(2:varint),
  file_version(3:bytes) / summary(5:message), with Summary.Value
  carrying tag(1), simple_value(2:float32) or histo(5:HistogramProto).

tests/test_torch_tb_events.py holds the records to the JAX package's
writer and reads each package's files with the other's reader.

Records here are tiny (scalars ~60 B, histograms ~700 B), so the pure-
Python CRC is nowhere near any hot path.
"""

from __future__ import annotations

import itertools
import os
import socket
import struct
import threading
import time

import numpy as np

# process-wide uniquifier for event filenames (see TBEventWriter.__init__)
_FILE_COUNTER = itertools.count()

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), table-driven, as used by the TFRecord framing.
# ---------------------------------------------------------------------------

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ (0x82F63B78 if _c & 1 else 0)
    _CRC_TABLE.append(_c)


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Minimal protobuf wire-format encoders (only what Event/Summary need).
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _float32(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _varint_field(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _bytes_field(field: int, b: bytes) -> bytes:
    return _key(field, 2) + _varint(len(b)) + b


def _packed_doubles(field: int, vals) -> bytes:
    vals = np.asarray(vals, np.float64)
    return _bytes_field(field, vals.tobytes())


def _event(*, wall_time: float, step: int = 0, file_version: str | None = None,
           summary: bytes | None = None) -> bytes:
    msg = _double(1, wall_time) + _varint_field(2, step)
    if file_version is not None:
        msg += _bytes_field(3, file_version.encode())
    if summary is not None:
        msg += _bytes_field(5, summary)
    return msg


def _scalar_value(tag: str, value: float) -> bytes:
    return _bytes_field(1, _bytes_field(1, tag.encode()) + _float32(2, float(value)))


def encode_histogram(values: np.ndarray, bins: int = 30) -> bytes:
    """HistogramProto for a flat array (min/max/num/sum/sum_squares +
    right-edge bucket_limit / counts, the layout TensorBoard's histogram
    plugin consumes)."""
    v = np.asarray(values, np.float64).ravel()
    counts, edges = np.histogram(v, bins=bins)
    return (
        _double(1, float(v.min()))
        + _double(2, float(v.max()))
        + _double(3, float(v.size))
        + _double(4, float(v.sum()))
        + _double(5, float(np.square(v).sum()))
        + _packed_doubles(6, edges[1:])
        + _packed_doubles(7, counts)
    )


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------


class TBEventWriter:
    """Append-only events.out.tfevents.* writer.

    Thread-safe (the Trainer writes scalars from the main loop and
    parameter histograms from the async-checkpoint worker thread).
    """

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        host = socket.gethostname() or "localhost"
        # hostname+pid+monotonic counter keeps paths unique even when two
        # writers open the same logdir within one wall-clock second (quick
        # stop/resume) — second-resolution time alone collides, and append
        # mode would then interleave a second file_version header mid-file
        self.path = os.path.join(
            logdir,
            f"events.out.tfevents.{int(time.time())}.{host}"
            f".{os.getpid()}.{next(_FILE_COUNTER)}",
        )
        self._fh = open(self.path, "ab")
        self._lock = threading.Lock()
        # every event file leads with its format version
        self._write_record(
            _event(wall_time=time.time(), file_version="brain.Event:2")
        )

    def _write_record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        rec = (
            header
            + struct.pack("<I", masked_crc(header))
            + payload
            + struct.pack("<I", masked_crc(payload))
        )
        with self._lock:
            self._fh.write(rec)
            self._fh.flush()

    def add_scalars(self, step: int, scalars: dict[str, float]) -> None:
        """One Event carrying every (tag, value) pair for this step."""
        if not scalars:
            return
        summary = b"".join(_scalar_value(t, v) for t, v in scalars.items())
        self._write_record(
            _event(wall_time=time.time(), step=int(step), summary=summary)
        )

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self.add_scalars(step, {tag: value})

    def add_histogram(self, tag: str, values, step: int) -> None:
        v = np.asarray(values)
        if v.size == 0 or not np.all(np.isfinite(v)):
            return
        summary = _bytes_field(
            1, _bytes_field(1, tag.encode()) + _bytes_field(5, encode_histogram(v))
        )
        self._write_record(
            _event(wall_time=time.time(), step=int(step), summary=summary)
        )

    def add_param_histograms(self, step: int, state_dict) -> None:
        """One histogram per tensor of a module's state dict, tagged by its
        path as the JAX package tags a param tree's leaves
        (`generator.decoder.fc1.kernel` -> params/generator/decoder/fc1/kernel),
        in the sorted order of the JAX tree's leaves."""
        for name in sorted(state_dict):
            values = state_dict[name].detach().float().cpu().numpy()
            self.add_histogram("params/" + name.replace(".", "/"), values, step)

    def close(self) -> None:
        with self._lock:
            self._fh.close()


# ---------------------------------------------------------------------------
# Reader (verification and tooling)
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    out = shift = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _parse_fields(buf: bytes):
    """Yield (field_number, wire_type, value) for one message."""
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, i = _read_varint(buf, i)
        elif wire == 1:
            val = struct.unpack_from("<d", buf, i)[0]
            i += 8
        elif wire == 5:
            val = struct.unpack_from("<f", buf, i)[0]
            i += 4
        elif wire == 2:
            ln, i = _read_varint(buf, i)
            val = buf[i : i + ln]
            i += ln
        else:  # pragma: no cover - groups never emitted here
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def read_events(path: str) -> list[dict]:
    """Decode an event file written by TBEventWriter (CRC-checked).

    Returns one dict per event: {step, wall_time, file_version?,
    scalars: {tag: float}, histograms: {tag: {min,max,num,sum,
    sum_squares,bucket_limit,bucket}}}.
    """
    events = []
    with open(path, "rb") as fh:
        data = fh.read()
    i = 0
    while i < len(data):
        header = data[i : i + 8]
        (length,) = struct.unpack("<Q", header)
        (hcrc,) = struct.unpack_from("<I", data, i + 8)
        payload = data[i + 12 : i + 12 + length]
        (pcrc,) = struct.unpack_from("<I", data, i + 12 + length)
        if hcrc != masked_crc(header) or pcrc != masked_crc(payload):
            raise ValueError(f"corrupt TFRecord at offset {i} in {path}")
        i += 12 + length + 4
        ev: dict = {"step": 0, "scalars": {}, "histograms": {}}
        for field, _, val in _parse_fields(payload):
            if field == 1:
                ev["wall_time"] = val
            elif field == 2:
                ev["step"] = val
            elif field == 3:
                ev["file_version"] = val.decode()
            elif field == 5:
                for vf, _, vv in _parse_fields(val):
                    if vf != 1:
                        continue
                    tag, scalar, histo = None, None, None
                    for f2, _, v2 in _parse_fields(vv):
                        if f2 == 1:
                            tag = v2.decode()
                        elif f2 == 2:
                            scalar = v2
                        elif f2 == 5:
                            histo = v2
                    if scalar is not None:
                        ev["scalars"][tag] = scalar
                    if histo is not None:
                        names = {1: "min", 2: "max", 3: "num", 4: "sum", 5: "sum_squares"}
                        h: dict = {}
                        for f3, w3, v3 in _parse_fields(histo):
                            if f3 in names:
                                h[names[f3]] = v3
                            elif f3 in (6, 7):
                                key = "bucket_limit" if f3 == 6 else "bucket"
                                h[key] = np.frombuffer(v3, np.float64)
                        ev["histograms"][tag] = h
        events.append(ev)
    return events


def tb_tag(key: str) -> str:
    """Map a metrics.jsonl key to a TensorBoard tag.

    Mirrors the reference's grouping: training scalars at top level
    (reference lib/models.py:400-405), EMA under averages/ (:407-411),
    validation under validation/ (:919-920).
    """
    if key.startswith("val_"):
        return "validation/" + key[4:]
    if key.endswith("_ema"):
        return "averages/" + key[:-4]
    return "train/" + key
