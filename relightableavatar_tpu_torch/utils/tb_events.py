"""TensorBoard event-file writer with zero dependencies: a copy of
``relightableavatar_tpu/utils/tb_events.py`` for the port.

The reference recorder logs scalars through
``torch.utils.tensorboard.SummaryWriter`` (``lib/train/recorder.py:5,64-100``);
this repo's primary record stream is ``scalars.jsonl`` (greppable, diffable),
but reference users point TensorBoard at ``record_dir`` — so the Recorder
additionally emits a real ``events.out.tfevents.*`` file any stock
TensorBoard install can read.

No tensorboard or protobuf dependency is needed: an event file is a
TFRecord stream of hand-encodable ``Event`` protos —

  record   = uint64 len | masked_crc32c(len) | data | masked_crc32c(data)
  Event    = { 1: wall_time (double), 2: step (int64),
               3: file_version (string) | 5: Summary }
  Summary  = { 1: repeated Value }
  Value    = { 1: tag (string), 2: simple_value (float) }

crc32c (Castagnoli, reflected 0x1EDC6F41) is table-driven below; the mask is
TFRecord's ``((crc >> 15 | crc << 17) + 0xa282ead8) mod 2^32``.
"""
from __future__ import annotations

import os
import socket
import struct
import time

# ----------------------------------------------------------------- crc32c
_POLY = 0x82F63B78  # reflected Castagnoli
_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ _POLY if _c & 1 else _c >> 1
    _TABLE.append(_c)


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ----------------------------------------------------- proto wire helpers
def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _tag_bytes(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f_double(field: int, v: float) -> bytes:
    return _tag_bytes(field, 1) + struct.pack('<d', v)


def _f_float(field: int, v: float) -> bytes:
    return _tag_bytes(field, 5) + struct.pack('<f', v)


def _f_varint(field: int, v: int) -> bytes:
    return _tag_bytes(field, 0) + _varint(v)


def _f_bytes(field: int, v: bytes) -> bytes:
    return _tag_bytes(field, 2) + _varint(len(v)) + v


def _event(wall_time: float, step: int, body: bytes) -> bytes:
    return _f_double(1, wall_time) + _f_varint(2, step) + body


# ----------------------------------------------------------------- writer
class EventWriter:
    """Append-mode scalar event writer (one file per training run)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        name = f'events.out.tfevents.{int(time.time())}.{socket.gethostname()}'
        self._f = open(os.path.join(log_dir, name), 'ab')
        self._record(_event(time.time(), 0,
                            _f_bytes(3, b'brain.Event:2')))

    def _record(self, data: bytes):
        header = struct.pack('<Q', len(data))
        self._f.write(header)
        self._f.write(struct.pack('<I', _masked_crc(header)))
        self._f.write(data)
        self._f.write(struct.pack('<I', _masked_crc(data)))

    def add_scalars(self, scalars: dict, step: int,
                    wall_time: float | None = None):
        """One Event carrying every (tag, value) in ``scalars``."""
        vals = b''.join(
            _f_bytes(1, _f_bytes(1, tag.encode()) + _f_float(2, float(v)))
            for tag, v in scalars.items())
        self._record(_event(wall_time if wall_time is not None
                            else time.time(), int(step), _f_bytes(5, vals)))
        self._f.flush()

    def close(self):
        self._f.close()


# ------------------------------------------------------- reader (for tests)
def read_events(path: str):
    """Parse an event file back to [(wall_time, step, {tag: value})] —
    validates both CRCs of every record (test oracle; also handy for
    post-mortem without a TensorBoard install)."""
    out = []
    with open(path, 'rb') as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return out
            (hcrc,) = struct.unpack('<I', f.read(4))
            assert hcrc == _masked_crc(header), 'corrupt length crc'
            (n,) = struct.unpack('<Q', header)
            data = f.read(n)
            (dcrc,) = struct.unpack('<I', f.read(4))
            assert dcrc == _masked_crc(data), 'corrupt data crc'
            out.append(_parse_event(data))


def _read_varint(data: bytes, i: int):
    shift = v = 0
    while True:
        b = data[i]
        i += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, i
        shift += 7


def _fields(data: bytes):
    i = 0
    while i < len(data):
        key, i = _read_varint(data, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _read_varint(data, i)
        elif wire == 1:
            v, i = data[i:i + 8], i + 8
        elif wire == 5:
            v, i = data[i:i + 4], i + 4
        elif wire == 2:
            n, i = _read_varint(data, i)
            v, i = data[i:i + n], i + n
        else:
            raise ValueError(f'wire type {wire}')
        yield field, wire, v


def _parse_event(data: bytes):
    wall, step, scalars = 0.0, 0, {}
    for field, wire, v in _fields(data):
        if field == 1 and wire == 1:
            (wall,) = struct.unpack('<d', v)
        elif field == 2 and wire == 0:
            step = v
        elif field == 5 and wire == 2:  # Summary
            for f2, _, val in _fields(v):
                if f2 != 1:
                    continue
                tag, sv = None, None
                for f3, w3, x in _fields(val):
                    if f3 == 1 and w3 == 2:
                        tag = x.decode()
                    elif f3 == 2 and w3 == 5:
                        (sv,) = struct.unpack('<f', x)
                if tag is not None and sv is not None:
                    scalars[tag] = sv
    return wall, step, scalars
