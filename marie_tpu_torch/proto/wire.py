"""Protobuf wire-format codec (copy of ``marie_tpu/proto/pbwire.py``,
extended).

Messages here are dicts of ``field_number -> value(s)``; the schema-aware
codec of the serving plane (:mod:`marie_tpu_torch.proto.messages`) is
built on the primitives below.  Beyond the JAX module's varint and
length-delimited types this reads and writes fixed64 (``double``) and
fixed32 (``float``), packed repeated varints, negative ``int32`` /
``int64`` as 10-byte two's-complement varints, skips fields of unknown
numbers, and raises ``ValueError`` on truncated or over-long input.
"""

import struct
from typing import Dict, List, Tuple, Union

Value = Union[int, bytes, "Msg"]
Msg = Dict[int, Union[Value, List[Value]]]

VARINT, FIXED64, LEN, FIXED32 = 0, 1, 2, 5

_U64 = (1 << 64) - 1
_DOUBLE = struct.Struct("<d")
_FLOAT = struct.Struct("<f")


def write_varint(out: bytearray, value: int) -> None:
    """Append ``value`` as a varint; a negative value is its 64-bit two's
    complement (10 bytes), as protobuf writes a negative int32/int64."""
    if value < 0:
        value &= _U64
    while value > 0x7F:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)


def read_varint(data, pos: int) -> Tuple[int, int]:
    """(value, next position) of the varint at ``pos``; ValueError when it
    runs past the end or past 10 bytes."""
    result = 0
    shift = 0
    n = len(data)
    while True:
        if pos >= n:
            raise ValueError("truncated varint")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result & _U64, pos
        shift += 7
        if shift >= 70:
            raise ValueError("varint too long")


def write_tag(out: bytearray, field: int, wire: int) -> None:
    write_varint(out, (field << 3) | wire)


def write_len(out: bytearray, field: int, payload) -> None:
    """A length-delimited field: tag, length, bytes."""
    write_varint(out, (field << 3) | LEN)
    write_varint(out, len(payload))
    out += payload


def write_double(out: bytearray, field: int, value: float) -> None:
    write_varint(out, (field << 3) | FIXED64)
    out += _DOUBLE.pack(value)


def write_float(out: bytearray, field: int, value: float) -> None:
    write_varint(out, (field << 3) | FIXED32)
    out += _FLOAT.pack(value)


def to_int32(v: int) -> int:
    """A decoded varint as a signed 32-bit integer (protobuf truncates)."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v & 0x80000000 else v


def to_int64(v: int) -> int:
    v &= _U64
    return v - (1 << 64) if v & (1 << 63) else v


def unpack_double(raw: bytes) -> float:
    return _DOUBLE.unpack(raw)[0]


def unpack_float(raw: bytes) -> float:
    return _FLOAT.unpack(raw)[0]


def iter_fields(data, pos: int = 0, end: int = -1):
    """Yield ``(field, wire type, value)`` of each field in ``data[pos:end]``:
    an int for varints, the raw bytes of fixed64 / fixed32 and
    length-delimited fields.  Raises ValueError on a truncated field or an
    unknown wire type (groups, 3 and 4, are not protobuf 3)."""
    if end < 0:
        end = len(data)
    view = memoryview(data)
    while pos < end:
        tag, pos = read_varint(data, pos)
        field, wire = tag >> 3, tag & 0x7
        if field == 0:
            raise ValueError("field number 0")
        if wire == VARINT:
            value, pos = read_varint(data, pos)
        elif wire == LEN:
            length, pos = read_varint(data, pos)
            if pos + length > end:
                raise ValueError("truncated length-delimited field")
            value = bytes(view[pos:pos + length])
            pos += length
        elif wire == FIXED64:
            if pos + 8 > end:
                raise ValueError("truncated fixed64 field")
            value = bytes(view[pos:pos + 8])
            pos += 8
        elif wire == FIXED32:
            if pos + 4 > end:
                raise ValueError("truncated fixed32 field")
            value = bytes(view[pos:pos + 4])
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, value
    if pos != end:
        raise ValueError("field runs past the end of the message")


def unpack_varints(raw: bytes) -> List[int]:
    """The values of a packed repeated varint field."""
    out, pos = [], 0
    while pos < len(raw):
        v, pos = read_varint(raw, pos)
        out.append(v)
    return out


def encode(msg: Msg) -> bytes:
    """Encode {field: value-or-list} (the JAX module's form): int ->
    varint; bytes/str -> bytes; dict -> nested message; float -> double."""
    out = bytearray()
    for field in sorted(msg):
        values = msg[field]
        if not isinstance(values, list):
            values = [values]
        for value in values:
            if isinstance(value, bool):
                value = int(value)
            if isinstance(value, int):
                write_tag(out, field, VARINT)
                write_varint(out, value)
            elif isinstance(value, float):
                write_double(out, field, value)
            else:
                if isinstance(value, dict):
                    value = encode(value)
                elif isinstance(value, str):
                    value = value.encode()
                write_len(out, field, value)
    return bytes(out)


def decode(data: bytes) -> Dict[int, List[Value]]:
    """Decode into {field: [raw values]}; length-delimited fields stay
    bytes (call decode() again for nested messages), fixed fields are
    their little-endian unsigned integers."""
    out: Dict[int, List[Value]] = {}
    for field, wire, value in iter_fields(data):
        if wire in (FIXED64, FIXED32):
            value = int.from_bytes(value, "little")
        out.setdefault(field, []).append(value)
    return out


def first(msg: Dict[int, List[Value]], field: int, default=None):
    values = msg.get(field)
    return values[0] if values else default
