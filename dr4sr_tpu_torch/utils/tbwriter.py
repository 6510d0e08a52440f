"""Minimal pure-Python TensorBoard scalar writer.

A copy of ``dr4sr_tpu/utils/tbwriter.py``: the trainer's per-epoch scalars
go to ``train.tensorboard_dir`` without depending on the ``tensorboard``
package. It writes the TFRecord event-file format
directly — varint-protobuf-encoded ``Event`` messages with masked-CRC32C
framing — and is readable by any standard TensorBoard.

Format references (public): TFRecord framing is
``[len u64][crc32c(len)][bytes][crc32c(bytes)]`` with the Castagnoli
polynomial and TF's rotate+offset masking; the ``Event``/``Summary`` protos
only need fields wall_time(1,double), step(2,varint), file_version(3,string),
summary(5,msg) / value(1,msg){tag(1,string), simple_value(2,float)}.
"""

from __future__ import annotations

import os
import socket
import struct
import threading
import time
from typing import Optional

# ---------------------------------------------------------------- crc32c
_CRC_TABLE = []


def _build_table() -> None:
    poly = 0x82F63B78  # reflected Castagnoli
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        _CRC_TABLE.append(crc)


_build_table()


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ------------------------------------------------------------- protobuf
def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _str_field(field: int, s: bytes) -> bytes:
    return _key(field, 2) + _varint(len(s)) + s


def _scalar_event(wall_time: float, step: int, tag: str, value: float) -> bytes:
    val = _str_field(1, tag.encode()) + _key(2, 5) + struct.pack("<f", value)
    summary = _str_field(1, val)
    return (
        _key(1, 1) + struct.pack("<d", wall_time)
        + _key(2, 0) + _varint(step)
        + _str_field(5, summary)
    )


def _version_event(wall_time: float) -> bytes:
    return (
        _key(1, 1) + struct.pack("<d", wall_time)
        + _str_field(3, b"brain.Event:2")
    )


class SummaryWriter:
    """Scalar-only drop-in for ``torch.utils.tensorboard.SummaryWriter``."""

    def __init__(self, log_dir: str) -> None:
        os.makedirs(log_dir, exist_ok=True)
        host = socket.gethostname()
        fname = f"events.out.tfevents.{int(time.time())}.{host}"
        self._path = os.path.join(log_dir, fname)
        self._file = open(self._path, "ab")
        self._lock = threading.Lock()
        self._write(_version_event(time.time()))

    def _write(self, event: bytes) -> None:
        header = struct.pack("<Q", len(event))
        rec = (
            header + struct.pack("<I", _masked_crc(header))
            + event + struct.pack("<I", _masked_crc(event))
        )
        with self._lock:
            self._file.write(rec)
            self._file.flush()

    def add_scalar(self, tag: str, value: float, step: int = 0,
                   walltime: Optional[float] = None) -> None:
        self._write(_scalar_event(walltime or time.time(), step, tag,
                                  float(value)))

    def flush(self) -> None:
        with self._lock:
            self._file.flush()

    def close(self) -> None:
        with self._lock:
            if not self._file.closed:
                self._file.close()
