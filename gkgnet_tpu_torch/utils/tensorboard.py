"""Minimal, dependency-free TensorBoard scalar writer (counterpart:
``gkgnet_tpu/utils/tensorboard.py``, a copy).

The reference registers mmcv's ``TensorboardLoggerHook`` next to the text
logger (configs/gkgnet/gkgnet_coco_576.py:136-141). Without a dependency on
tensorflow/tensorboard, this module hand-encodes the two protos a scalar
stream needs (Event + Summary) and the TFRecord framing (length + masked
crc32c), producing standard ``events.out.tfevents.*`` files that TensorBoard
reads as-is.

Wire format notes:
  * protobuf: varint keys ``(field_num << 3) | wire_type``; wire types used
    here are 0 (varint), 1 (fixed64), 5 (fixed32), 2 (length-delimited).
  * Event: 1=wall_time(double), 2=step(int64), 3=file_version(string),
    5=summary(Summary). Summary: 1=repeated Value; Value: 1=tag(string),
    2=simple_value(float).
  * TFRecord: u64 length, u32 masked_crc(length), payload, u32
    masked_crc(payload); crc32c (Castagnoli), mask =
    ((crc >> 15 | crc << 17) + 0xa282ead8) mod 2^32.
"""

from __future__ import annotations

import os
import socket
import struct
import time

_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78  # Castagnoli, reversed
        table = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ (poly if crc & 1 else 0)
            table.append(crc)
        _CRC_TABLE = table
    return _CRC_TABLE


def _crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


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


def _double_field(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _float_field(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _int_field(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v)


def _bytes_field(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def _scalar_event(tag: str, value: float, step: int, wall_time: float) -> bytes:
    val = _bytes_field(1, tag.encode()) + _float_field(2, float(value))
    summary = _bytes_field(1, val)
    return (_double_field(1, wall_time) + _int_field(2, int(step))
            + _bytes_field(5, summary))


def _version_event(wall_time: float) -> bytes:
    return _double_field(1, wall_time) + _bytes_field(3, b"brain.Event:2")


class TensorboardWriter:
    """Append-only scalar event writer; one tfevents file per instance."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{socket.gethostname()}.{os.getpid()}.0")
        self._f = open(os.path.join(log_dir, fname), "wb")
        self._write_record(_version_event(time.time()))

    def _write_record(self, payload: bytes):
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag: str, value: float, step: int):
        self._write_record(_scalar_event(tag, value, step, time.time()))

    def add_scalars(self, scalars: dict, step: int, prefix: str = ""):
        for k, v in scalars.items():
            try:
                self.add_scalar(prefix + k, float(v), step)
            except (TypeError, ValueError):
                continue

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()
