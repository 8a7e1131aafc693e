"""TFRecord container format, numpy and struct only (no TensorFlow).

The port's own copy of ``ldm_tf2_tpu.data.tfrecord``.  Wire format:
    uint64 length (little-endian)
    uint32 masked_crc32c(length_bytes)
    bytes  payload[length]
    uint32 masked_crc32c(payload)
where masked_crc = ((crc >> 15 | crc << 17) + 0xa282ead8) mod 2^32 and the
CRC is CRC-32C (Castagnoli, reflected, poly 0x1EDC6F41).  Files are
byte-compatible with the JAX package's and TensorFlow's.
"""

from __future__ import annotations

import os
import struct
from typing import Iterator

import numpy as np

# Table-driven CRC-32C over numpy for speed (vectorized per byte of the
# 8/4-byte headers; payload CRC is computed via the same table walk).
_CRC32C_POLY = 0x82F63B78  # reflected 0x1EDC6F41


def _make_table() -> np.ndarray:
    table = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (_CRC32C_POLY if crc & 1 else 0)
        table[i] = crc
    return table


_TABLE = _make_table()
# 8-bit-at-a-time slicing tables (slice-by-8) for fast payload CRC.
_TABLES = [_TABLE]
for _ in range(7):
    prev = _TABLES[-1]
    _TABLES.append(
        (prev >> np.uint32(8)) ^ _TABLE[(prev & np.uint32(0xFF)).astype(np.uint8)]
    )


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), slice-by-8."""
    crc = np.uint32(0xFFFFFFFF)
    buf = np.frombuffer(data, dtype=np.uint8)
    n8 = len(buf) // 8 * 8
    if n8:
        chunks = buf[:n8].reshape(-1, 8)
        crc_val = int(crc)
        t = _TABLES
        for row in chunks:
            x = crc_val ^ int.from_bytes(row[:4].tobytes(), "little")
            y = int.from_bytes(row[4:].tobytes(), "little")
            crc_val = int(
                t[7][x & 0xFF]
                ^ t[6][(x >> 8) & 0xFF]
                ^ t[5][(x >> 16) & 0xFF]
                ^ t[4][(x >> 24) & 0xFF]
                ^ t[3][y & 0xFF]
                ^ t[2][(y >> 8) & 0xFF]
                ^ t[1][(y >> 16) & 0xFF]
                ^ t[0][(y >> 24) & 0xFF]
            )
        crc = np.uint32(crc_val)
    for b in buf[n8:]:
        crc = np.uint32(
            (int(crc) >> 8) ^ int(_TABLE[(int(crc) ^ int(b)) & 0xFF])
        )
    return int(crc ^ np.uint32(0xFFFFFFFF))


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


class TFRecordWriter:
    """Byte-compatible with tf.io.TFRecordWriter."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "wb")

    def write(self, record: bytes) -> None:
        length = struct.pack("<Q", len(record))
        self._f.write(length)
        self._f.write(struct.pack("<I", _masked_crc(length)))
        self._f.write(record)
        self._f.write(struct.pack("<I", _masked_crc(record)))

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class TFRecordReader:
    """Iterates records of a TFRecord file.

    CRC verification is optional (off by default on the hot path; the
    training loader re-reads files continuously and the checksums were
    verified at conversion time).
    """

    def __init__(self, path: str, verify_crc: bool = False):
        self._path = path
        self._verify = verify_crc

    def __iter__(self) -> Iterator[bytes]:
        with open(self._path, "rb") as f:
            while True:
                header = f.read(12)
                if len(header) < 12:
                    return
                (length,) = struct.unpack("<Q", header[:8])
                if self._verify:
                    (length_crc,) = struct.unpack("<I", header[8:12])
                    if _masked_crc(header[:8]) != length_crc:
                        raise IOError(f"corrupt length crc in {self._path}")
                payload = f.read(length)
                footer = f.read(4)
                if len(payload) < length or len(footer) < 4:
                    raise IOError(f"truncated record in {self._path}")
                if self._verify:
                    (payload_crc,) = struct.unpack("<I", footer)
                    if _masked_crc(payload) != payload_crc:
                        raise IOError(f"corrupt payload crc in {self._path}")
                yield payload
