"""The serving plane's protobuf schemas, written out as field tables (no
code generation, no ``protobuf`` package).

They cover every message of ``marie_tpu/proto/marie.proto`` (package
``jina``) and ``docarray.proto`` (package ``docarray``), the
``google.protobuf`` ``Struct``, ``Value``, ``ListValue``, ``Timestamp`` and
``Empty``, and ``grpc.health.v1``'s check messages.  A message is a dict
of its present fields by name: a sub-message is a dict, a repeated field
a list, a map a dict, an enum an int.

:func:`encode` writes what ``SerializeToString(deterministic=True)`` of
the ``protobuf`` package writes for the same content, byte for byte:
fields in field-number order; a proto3 scalar left out at its default,
except inside a ``oneof`` and for a present ``optional`` field; a
sub-message written whenever it is present, even empty; map entries
sorted by key (bytewise, a key before its prefixes), each with its key
and value written even at their defaults; repeated numbers packed.
:func:`decode` reads any valid encoding of a message (packed or not,
fields in any order), skips fields of unknown numbers and raises
``ValueError`` on truncated input.
"""

import math
from typing import Any, Dict, List, Tuple

from marie_tpu_torch.proto import wire

# (number, name, kind, type).  kind: "s" a proto3 scalar or message
# (a scalar with implicit presence), "o" an ``optional`` scalar, "r"
# repeated, "m" a map (type = (key type, value type)), "1<group>" a member
# of oneof <group>.  A type that is not a scalar's name is a message's.
SCHEMAS: Dict[str, List[Tuple[int, str, str, Any]]] = {
    # google.protobuf
    "google.protobuf.Empty": [],
    "google.protobuf.Timestamp": [(1, "seconds", "s", "int64"), (2, "nanos", "s", "int32")],
    "google.protobuf.Struct": [
        (1, "fields", "m", ("string", "google.protobuf.Value"))],
    "google.protobuf.Value": [
        (1, "null_value", "1kind", "enum"),
        (2, "number_value", "1kind", "double"),
        (3, "string_value", "1kind", "string"),
        (4, "bool_value", "1kind", "bool"),
        (5, "struct_value", "1kind", "google.protobuf.Struct"),
        (6, "list_value", "1kind", "google.protobuf.ListValue")],
    "google.protobuf.ListValue": [(1, "values", "r", "google.protobuf.Value")],
    # docarray.proto
    "docarray.DenseNdArrayProto": [
        (1, "buffer", "s", "bytes"), (2, "shape", "r", "uint32"), (3, "dtype", "s", "string")],
    "docarray.NdArrayProto": [
        (1, "dense", "s", "docarray.DenseNdArrayProto"),
        (2, "parameters", "s", "google.protobuf.Struct")],
    "docarray.KeyValuePair": [
        (1, "key", "s", "google.protobuf.Value"), (2, "value", "s", "google.protobuf.Value")],
    "docarray.GenericDictValue": [(1, "entries", "r", "docarray.KeyValuePair")],
    "docarray.NodeProto": [
        (1, "text", "1content", "string"),
        (2, "integer", "1content", "int32"),
        (3, "float", "1content", "double"),
        (4, "boolean", "1content", "bool"),
        (5, "blob", "1content", "bytes"),
        (6, "ndarray", "1content", "docarray.NdArrayProto"),
        (7, "doc", "1content", "docarray.DocProto"),
        (8, "doc_array", "1content", "docarray.DocListProto"),
        (9, "list", "1content", "docarray.ListOfAnyProto"),
        (10, "set", "1content", "docarray.ListOfAnyProto"),
        (11, "tuple", "1content", "docarray.ListOfAnyProto"),
        (12, "dict", "1content", "docarray.DictOfAnyProto"),
        (13, "type", "1docarray_type", "string")],
    "docarray.DocProto": [(1, "data", "m", ("string", "docarray.NodeProto"))],
    "docarray.DictOfAnyProto": [(1, "data", "m", ("string", "docarray.NodeProto"))],
    "docarray.ListOfAnyProto": [(1, "data", "r", "docarray.NodeProto")],
    "docarray.DocListProto": [(1, "docs", "r", "docarray.DocProto")],
    "docarray.ListOfDocArrayProto": [(1, "data", "r", "docarray.DocListProto")],
    "docarray.DocVecProto": [
        (1, "tensor_columns", "m", ("string", "docarray.NdArrayProto")),
        (2, "doc_columns", "m", ("string", "docarray.DocVecProto")),
        (3, "docs_vec_columns", "m", ("string", "docarray.ListOfDocArrayProto")),
        (4, "any_columns", "m", ("string", "docarray.ListOfAnyProto"))],
    # marie.proto (package jina)
    "jina.RouteProto": [
        (1, "executor", "s", "string"),
        (2, "start_time", "s", "google.protobuf.Timestamp"),
        (3, "end_time", "s", "google.protobuf.Timestamp"),
        (4, "status", "s", "jina.StatusProto")],
    "jina.JinaInfoProto": [
        (1, "jina", "m", ("string", "string")), (2, "envs", "m", ("string", "string"))],
    "jina.HeaderProto": [
        (1, "request_id", "s", "string"),
        (2, "status", "s", "jina.StatusProto"),
        (3, "exec_endpoint", "o", "string"),
        (4, "target_executor", "o", "string"),
        (5, "timeout", "o", "uint32")],
    "jina.EndpointsProto": [
        (1, "endpoints", "r", "string"), (2, "write_endpoints", "r", "string"),
        (3, "schemas", "s", "google.protobuf.Struct")],
    "jina.StatusProto": [
        (1, "code", "s", "enum"), (2, "description", "s", "string"),
        (3, "exception", "s", "jina.StatusProto.ExceptionProto")],
    "jina.StatusProto.ExceptionProto": [
        (1, "name", "s", "string"), (2, "args", "r", "string"), (3, "stacks", "r", "string"),
        (4, "executor", "s", "string")],
    "jina.RelatedEntity": [
        (1, "id", "s", "string"), (2, "address", "s", "string"), (3, "port", "s", "uint32"),
        (4, "shard_id", "o", "uint32")],
    "jina.DataRequestProto": [
        (1, "header", "s", "jina.HeaderProto"),
        (2, "parameters", "s", "google.protobuf.Struct"),
        (3, "routes", "r", "jina.RouteProto"),
        (4, "data", "s", "jina.DataRequestProto.DataContentProto")],
    "jina.DataRequestProto.DataContentProto": [
        (1, "docs", "1documents", "docarray.DocListProto"),
        (2, "docs_bytes", "1documents", "bytes")],
    "jina.SingleDocumentRequestProto": [
        (1, "header", "s", "jina.HeaderProto"),
        (2, "parameters", "s", "google.protobuf.Struct"),
        (3, "routes", "r", "jina.RouteProto"),
        (4, "document", "s", "docarray.DocProto")],
    "jina.DataRequestProtoWoData": [
        (1, "header", "s", "jina.HeaderProto"),
        (2, "parameters", "s", "google.protobuf.Struct"),
        (3, "routes", "r", "jina.RouteProto")],
    "jina.DataRequestListProto": [(1, "requests", "r", "jina.DataRequestProto")],
    "jina.SnapshotId": [(1, "value", "s", "string")],
    "jina.RestoreId": [(1, "value", "s", "string")],
    "jina.SnapshotStatusProto": [
        (1, "id", "s", "jina.SnapshotId"), (2, "status", "s", "enum"),
        (3, "snapshot_file", "s", "string")],
    "jina.RestoreSnapshotStatusProto": [
        (1, "id", "s", "jina.RestoreId"), (2, "status", "s", "enum")],
    "jina.RestoreSnapshotCommand": [(1, "snapshot_file", "s", "string")],
    # grpc/health/v1/health.proto
    "grpc.health.v1.HealthCheckRequest": [(1, "service", "s", "string")],
    "grpc.health.v1.HealthCheckResponse": [(1, "status", "s", "enum")],
}

# enum values the serving plane names
STATUS_SUCCESS, STATUS_ERROR = 0, 1
SNAPSHOT_SUCCEEDED, SNAPSHOT_FAILED, SNAPSHOT_NOT_FOUND = 4, 5, 6
RESTORE_SUCCEEDED, RESTORE_FAILED, RESTORE_NOT_FOUND = 2, 3, 6
HEALTH_SERVING = 1

_VARINT_TYPES = {"bool", "int32", "int64", "uint32", "uint64", "enum"}
_SCALARS = _VARINT_TYPES | {"string", "bytes", "double", "float"}

for _name, _fields in SCHEMAS.items():
    _fields.sort()
    for _f in _fields:
        _types = _f[3] if _f[2] == "m" else (_f[3],)
        for _t in _types:
            assert _t in _SCALARS or _t in SCHEMAS, (_name, _f)

_BY_NUMBER = {name: {f[0]: f[1:] for f in fields} for name, fields in SCHEMAS.items()}
_ONEOFS = {name: {f[1]: f[2][1:] for f in fields if f[2].startswith("1")}
           for name, fields in SCHEMAS.items()}


def _map_order(key):
    """The order ``SerializeToString(deterministic=True)`` writes string
    map keys in: bytewise, but a key before its own prefixes (``"ab"``
    before ``"a"``, ``""`` last).  UTF-8 never holds 0xFF, so the byte
    appended sorts every prefix after its extensions."""
    return key.encode("utf-8") + b"\xff" if isinstance(key, str) else key


def _is_default(ftype: str, v) -> bool:
    if ftype == "double" or ftype == "float":
        return v == 0.0 and math.copysign(1.0, v) > 0  # -0.0 is written
    return not v


def _write_scalar(out: bytearray, number: int, ftype: str, v) -> None:
    if ftype in _VARINT_TYPES:
        wire.write_tag(out, number, wire.VARINT)
        wire.write_varint(out, int(v))
    elif ftype == "string":
        wire.write_len(out, number, v.encode("utf-8"))
    elif ftype == "bytes":
        wire.write_len(out, number, v)
    elif ftype == "double":
        wire.write_double(out, number, v)
    else:
        wire.write_float(out, number, v)


def _write_value(out: bytearray, number: int, ftype: str, v, always: bool) -> None:
    if ftype in SCHEMAS:
        wire.write_len(out, number, encode(ftype, v))
    elif always or not _is_default(ftype, v):
        _write_scalar(out, number, ftype, v)


def _packed(ftype: str, values) -> bytearray:
    out = bytearray()
    for v in values:
        if ftype in _VARINT_TYPES:
            wire.write_varint(out, int(v))
        elif ftype == "double":
            out += wire._DOUBLE.pack(v)
        else:
            out += wire._FLOAT.pack(v)
    return out


def encode(name: str, msg: Dict[str, Any]) -> bytes:
    """The deterministic wire bytes of message ``name`` holding ``msg``."""
    out = bytearray()
    for number, fname, kind, ftype in SCHEMAS[name]:
        if fname not in msg:
            continue
        v = msg[fname]
        if kind == "r":
            if not v:
                continue
            if ftype in SCHEMAS or ftype in ("string", "bytes"):
                for item in v:
                    _write_value(out, number, ftype, item, True)
            else:
                wire.write_len(out, number, _packed(ftype, v))
        elif kind == "m":
            ktype, vtype = ftype
            for k in sorted(v, key=_map_order):
                entry = bytearray()
                _write_value(entry, 1, ktype, k, True)
                _write_value(entry, 2, vtype, v[k], True)
                wire.write_len(out, number, entry)
        else:
            _write_value(out, number, ftype, v, kind != "s")
    return bytes(out)


def _default(ftype: str):
    if ftype in SCHEMAS:
        return {}
    return {"string": "", "bytes": b"", "bool": False, "double": 0.0,
            "float": 0.0}.get(ftype, 0)


def _scalar(ftype: str, wire_type: int, raw):
    """A scalar from its wire value; None when the wire type is not the
    field's (the field is then skipped, as protobuf keeps it unknown)."""
    if ftype in _VARINT_TYPES:
        if wire_type != wire.VARINT:
            return None
        if ftype == "bool":
            return bool(raw)
        if ftype in ("int32", "enum"):
            return wire.to_int32(raw)
        if ftype == "int64":
            return wire.to_int64(raw)
        if ftype == "uint32":
            return raw & 0xFFFFFFFF
        return raw
    if ftype == "double":
        return wire.unpack_double(raw) if wire_type == wire.FIXED64 else None
    if ftype == "float":
        return wire.unpack_float(raw) if wire_type == wire.FIXED32 else None
    if wire_type != wire.LEN:
        return None
    return raw.decode("utf-8") if ftype == "string" else raw


def _unpacked(ftype: str, raw: bytes) -> list:
    if ftype in _VARINT_TYPES:
        return [_scalar(ftype, wire.VARINT, v) for v in wire.unpack_varints(raw)]
    size = 8 if ftype == "double" else 4
    if len(raw) % size:
        raise ValueError("truncated packed field")
    unpack = wire.unpack_double if size == 8 else wire.unpack_float
    return [unpack(raw[i:i + size]) for i in range(0, len(raw), size)]


def decode(name: str, data) -> Dict[str, Any]:
    """The present fields of message ``name`` read from ``data``."""
    fields = _BY_NUMBER[name]
    oneofs = _ONEOFS[name]
    out: Dict[str, Any] = {}
    for number, wire_type, raw in wire.iter_fields(data):
        spec = fields.get(number)
        if spec is None:
            continue  # a field of an unknown number
        fname, kind, ftype = spec
        if kind == "m":
            if wire_type != wire.LEN:
                continue
            ktype, vtype = ftype
            k, v = _default(ktype), _default(vtype)
            for n, wt, r in wire.iter_fields(raw):
                if n == 1:
                    got = _scalar(ktype, wt, r)
                    k = k if got is None else got
                elif n == 2:
                    if vtype in SCHEMAS:
                        v = decode(vtype, r) if wt == wire.LEN else v
                    else:
                        got = _scalar(vtype, wt, r)
                        v = v if got is None else got
            out.setdefault(fname, {})[k] = v
            continue
        if ftype in SCHEMAS:
            if wire_type != wire.LEN:
                continue
            value = decode(ftype, raw)
            if kind == "r":
                out.setdefault(fname, []).append(value)
                continue
            if fname in out:  # a repeated occurrence merges into the first
                value = decode(ftype, encode(ftype, out[fname]) + raw)
        elif kind == "r":
            if wire_type == wire.LEN and ftype not in ("string", "bytes"):
                out.setdefault(fname, []).extend(_unpacked(ftype, raw))
                continue
            value = _scalar(ftype, wire_type, raw)
            if value is not None:
                out.setdefault(fname, []).append(value)
            continue
        else:
            value = _scalar(ftype, wire_type, raw)
            if value is None:
                continue
        if kind.startswith("1"):
            for other, group in oneofs.items():
                if group == kind[1:] and other != fname:
                    out.pop(other, None)
        out[fname] = value
    return out


# --- google.protobuf.Struct <-> Python, as json_format does ---------------
def value_to_py(v: Dict[str, Any]):
    """``json_format.MessageToDict`` of a Value: numbers are floats."""
    if "number_value" in v:
        return float(v["number_value"])
    if "string_value" in v:
        return v["string_value"]
    if "bool_value" in v:
        return v["bool_value"]
    if "struct_value" in v:
        return struct_to_py(v["struct_value"])
    if "list_value" in v:
        return [value_to_py(x) for x in v["list_value"].get("values", [])]
    return None  # null_value, or no kind


def struct_to_py(s: Dict[str, Any]) -> Dict[str, Any]:
    return {k: value_to_py(v) for k, v in s.get("fields", {}).items()}


def py_to_value(v) -> Dict[str, Any]:
    """``json_format.ParseDict`` into a Value."""
    if isinstance(v, dict):
        return {"struct_value": py_to_struct(v)}
    if isinstance(v, (list, tuple)):
        return {"list_value": {"values": [py_to_value(x) for x in v]}}
    if v is None:
        return {"null_value": 0}
    if isinstance(v, bool):
        return {"bool_value": v}
    if isinstance(v, str):
        return {"string_value": v}
    if isinstance(v, (int, float)):
        return {"number_value": float(v)}
    raise ValueError(f"cannot put {type(v).__name__} into a google.protobuf.Value")


def py_to_struct(d: Dict[str, Any]) -> Dict[str, Any]:
    return {"fields": {str(k): py_to_value(v) for k, v in d.items()}}
