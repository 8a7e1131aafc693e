"""Minimal tf.train.Example protobuf codec (no TensorFlow, no protoc).

The port's own copy of ``ldm_tf2_tpu.data.example_proto``.  Message schema
(proto3 field numbers):

    Example  { Features features = 1; }
    Features { map<string, Feature> feature = 1; }
    Feature  { oneof kind { BytesList bytes_list = 1;
                            FloatList float_list = 2;
                            Int64List int64_list = 3; } }
    BytesList { repeated bytes value = 1; }
    FloatList { repeated float value = 1 [packed]; }
    Int64List { repeated int64 value = 1 [packed]; }

A map field is encoded as a repeated embedded message with key=1, value=2.
Only the features the trainers use are implemented; unknown fields are
skipped on decode.
"""

from __future__ import annotations

import struct
from typing import Mapping, Sequence


# ---------------------------- encoding ----------------------------


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


def _tag(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _len_delimited(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _encode_bytes_list(values: Sequence[bytes]) -> bytes:
    return b"".join(_len_delimited(1, v) for v in values)


def _encode_int64_list(values: Sequence[int]) -> bytes:
    packed = b"".join(_varint(v & 0xFFFFFFFFFFFFFFFF) for v in values)
    return _len_delimited(1, packed)


def _encode_float_list(values: Sequence[float]) -> bytes:
    packed = struct.pack(f"<{len(values)}f", *values)
    return _len_delimited(1, packed)


def encode_example(features: Mapping[str, object]) -> bytes:
    """Encode {name: bytes | list[bytes] | list[int] | list[float]} to a
    serialized tf.train.Example."""
    entries = []
    for name, value in features.items():
        if isinstance(value, bytes):
            feature = _len_delimited(1, _encode_bytes_list([value]))
        elif isinstance(value, (list, tuple)) and value and isinstance(
            value[0], bytes
        ):
            feature = _len_delimited(1, _encode_bytes_list(value))
        elif isinstance(value, (list, tuple)) and value and isinstance(
            value[0], float
        ):
            feature = _len_delimited(2, _encode_float_list(value))
        else:
            feature = _len_delimited(3, _encode_int64_list([int(v) for v in value]))
        entry = _len_delimited(1, name.encode()) + _len_delimited(2, feature)
        entries.append(_len_delimited(1, entry))
    features_msg = b"".join(entries)
    return _len_delimited(1, features_msg)


# ---------------------------- decoding ----------------------------


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
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
    """Yield (field_number, wire_type, value_bytes_or_int)."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            value, pos = _read_varint(buf, pos)
        elif wire == 2:  # length-delimited
            length, pos = _read_varint(buf, pos)
            value = buf[pos : pos + length]
            pos += length
        elif wire == 5:  # 32-bit
            value = buf[pos : pos + 4]
            pos += 4
        elif wire == 1:  # 64-bit
            value = buf[pos : pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, value


def _decode_signed_varint(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


def decode_example(data: bytes) -> dict[str, object]:
    """Decode a serialized tf.train.Example into
    {name: list[bytes] | list[int] | list[float]}."""
    out: dict[str, object] = {}
    for field, _, features_msg in _iter_fields(data):
        if field != 1:
            continue
        for f2, _, entry in _iter_fields(features_msg):
            if f2 != 1:
                continue
            name = None
            feature = None
            for f3, _, v in _iter_fields(entry):
                if f3 == 1:
                    name = v.decode()
                elif f3 == 2:
                    feature = v
            if name is None or feature is None:
                continue
            for kind, _, payload in _iter_fields(feature):
                if kind == 1:  # bytes_list
                    out[name] = [
                        v for f, _, v in _iter_fields(payload) if f == 1
                    ]
                elif kind == 2:  # float_list (packed or repeated)
                    values: list[float] = []
                    for f, wire, v in _iter_fields(payload):
                        if f != 1:
                            continue
                        if wire == 2:
                            values.extend(
                                struct.unpack(f"<{len(v) // 4}f", v)
                            )
                        else:
                            values.append(struct.unpack("<f", v)[0])
                    out[name] = values
                elif kind == 3:  # int64_list (packed or repeated)
                    ints: list[int] = []
                    for f, wire, v in _iter_fields(payload):
                        if f != 1:
                            continue
                        if wire == 2:
                            pos = 0
                            while pos < len(v):
                                val, pos = _read_varint(v, pos)
                                ints.append(_decode_signed_varint(val))
                        else:
                            ints.append(_decode_signed_varint(v))
                    out[name] = ints
    return out
