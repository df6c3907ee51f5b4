"""Dependency-free TensorBoard event-file writer/reader.

The reference logs through torch's SummaryWriter with manual-flush-only
settings (reference train_flownet.py:165-168) so metric history stays aligned
with checkpoints.  The TPU build ships its own minimal encoder for the
TFRecord + Event-proto format instead of pulling in torch/tensorflow:

- ``SummaryWriter``: add_scalar / flush / close, buffered in memory until an
  explicit flush (crash-consistent with checkpoints, same as the reference).
- ``read_events`` / ``write_events``: raw record round-trip used by
  ``scripts/fix_events.py`` to repair non-monotonic restart overlaps
  (reference scripts/fix_events.py:33-107) without a tensorflow dependency.

Only scalar summaries are encoded; that is the only summary kind the
reference emits.

The port's copy of ``dvs_of_training_framework_tpu/utils/tb.py``.
"""
import os
from pathlib import Path
import socket
import struct
import threading
import time


# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), required by the TFRecord framing.
# ---------------------------------------------------------------------------

_CRC_TABLE = []


def _make_crc_table():
    poly = 0x82F63B78
    table = []
    for n in range(256):
        crc = n
        for _ in range(8):
            crc = (crc >> 1) ^ (poly if crc & 1 else 0)
        table.append(crc)
    return table


def crc32c(data: bytes) -> int:
    global _CRC_TABLE
    if not _CRC_TABLE:
        _CRC_TABLE = _make_crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Minimal protobuf wire-format encoding for Event/Summary messages.
# ---------------------------------------------------------------------------

def _varint(value: int) -> bytes:
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _field_bytes(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _field_double(field: int, value: float) -> bytes:
    return _tag(field, 1) + struct.pack('<d', value)


def _field_float(field: int, value: float) -> bytes:
    return _tag(field, 5) + struct.pack('<f', value)


def _field_varint(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(value & 0xFFFFFFFFFFFFFFFF)


def encode_scalar_event(tag: str, value: float, step: int,
                        wall_time=None) -> bytes:
    """Serialise a tensorboard Event proto holding one scalar summary."""
    if wall_time is None:
        wall_time = time.time()
    # Summary.Value { tag = 1 (string); simple_value = 2 (float) }
    sval = _field_bytes(1, tag.encode()) + _field_float(2, float(value))
    # Summary { value = 1 (repeated message) }
    summary = _field_bytes(1, sval)
    # Event { wall_time = 1 (double); step = 2 (int64); summary = 5 (message) }
    return (_field_double(1, wall_time) + _field_varint(2, int(step)) +
            _field_bytes(5, summary))


def encode_file_version_event(wall_time=None) -> bytes:
    if wall_time is None:
        wall_time = time.time()
    # Event { wall_time = 1; file_version = 3 (string) }
    return _field_double(1, wall_time) + _field_bytes(3, b'brain.Event:2')


# ---------------------------------------------------------------------------
# Decoding (enough to read back what we and torch/tensorflow write).
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, pos: int):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes):
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _read_varint(buf, pos)
        elif wire == 1:
            value = buf[pos:pos + 8]
            pos += 8
        elif wire == 2:
            length, pos = _read_varint(buf, pos)
            value = buf[pos:pos + length]
            pos += length
        elif wire == 5:
            value = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f'unsupported wire type {wire}')
        yield field, wire, value


def decode_event(record: bytes):
    """Decode an Event record into {wall_time, step, scalars: {tag: value}}."""
    out = {'wall_time': 0.0, 'step': 0, 'scalars': {}}
    for field, wire, value in _iter_fields(record):
        if field == 1 and wire == 1:
            out['wall_time'] = struct.unpack('<d', value)[0]
        elif field == 2 and wire == 0:
            out['step'] = value
        elif field == 5 and wire == 2:
            for sfield, swire, svalue in _iter_fields(value):
                if sfield == 1 and swire == 2:
                    tag, sval = None, None
                    for vfield, vwire, vvalue in _iter_fields(svalue):
                        if vfield == 1 and vwire == 2:
                            tag = vvalue.decode('utf-8', 'replace')
                        elif vfield == 2 and vwire == 5:
                            sval = struct.unpack('<f', vvalue)[0]
                    if tag is not None and sval is not None:
                        out['scalars'][tag] = sval
    return out


# ---------------------------------------------------------------------------
# TFRecord framing.
# ---------------------------------------------------------------------------

def frame_record(payload: bytes) -> bytes:
    header = struct.pack('<Q', len(payload))
    return (header + struct.pack('<I', masked_crc(header)) +
            payload + struct.pack('<I', masked_crc(payload)))


def read_records(path):
    """Yield raw record payloads from a TFRecord-framed event file."""
    data = Path(path).read_bytes()
    pos = 0
    n = len(data)
    while pos + 12 <= n:
        (length,) = struct.unpack('<Q', data[pos:pos + 8])
        payload_start = pos + 12
        payload_end = payload_start + length
        if payload_end + 4 > n:
            break  # truncated tail (crash artifact) — stop cleanly
        yield data[payload_start:payload_end]
        pos = payload_end + 4


def write_records(path, records):
    with open(path, 'wb') as f:
        for record in records:
            f.write(frame_record(record))


def read_events(path):
    """Decode all events in a file into dicts (see ``decode_event``)."""
    return [decode_event(rec) for rec in read_records(path)]


# ---------------------------------------------------------------------------
# Writer.
# ---------------------------------------------------------------------------

class SummaryWriter:
    """Buffered scalar-only TensorBoard writer with manual flush.

    Events accumulate in memory and reach disk only on ``flush()`` — matching
    the reference's crash-consistency strategy where logs are flushed inside
    the checkpoint hook (reference utils/hooks/serialization.py:47).
    """

    def __init__(self, log_dir, filename_suffix=''):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        hostname = socket.gethostname()
        filename = (f'events.out.tfevents.{int(time.time())}.{hostname}'
                    f'.{os.getpid()}.0{filename_suffix}')
        self._path = self.log_dir / filename
        self._lock = threading.Lock()
        self._buffer = [frame_record(encode_file_version_event())]
        self._file = None

    def add_scalar(self, tag, value, global_step=0, walltime=None):
        record = frame_record(
            encode_scalar_event(tag, float(value), int(global_step),
                                wall_time=walltime))
        with self._lock:
            self._buffer.append(record)

    def flush(self):
        with self._lock:
            if not self._buffer:
                return
            if self._file is None:
                self._file = open(self._path, 'ab')
            for record in self._buffer:
                self._file.write(record)
            self._buffer = []
            self._file.flush()
            os.fsync(self._file.fileno())

    def close(self):
        self.flush()
        if self._file is not None:
            self._file.close()
            self._file = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.close()


class NullSummaryWriter:
    """No-op SummaryWriter stand-in.

    Non-zero processes of a multi-host run must not write TensorBoard
    events (process 0 owns observability; duplicate writers to the same
    log dir would interleave restart-style artifacts).
    """

    def add_scalar(self, tag, value, global_step=0, walltime=None):
        pass

    def flush(self):
        pass

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.close()
