"""The port's protobuf wire form and HTTP/2 header coding against the
reference implementations on this machine.

``proto/messages.py``'s field tables are held to the descriptors of the
JAX package's ``marie_pb2`` / ``docarray_pb2`` and to ``google.protobuf``'s
own (numbers, names, types, labels, oneofs, presence); random messages of
every schema encode to what ``SerializeToString(deterministic=True)``
writes and decode back.  ``DataRequest.to_bytes`` / ``to_request_list_bytes``
equal the JAX request's bytes for the same content (``hypothesis`` draws
parameters, documents, both wire modes, optional header fields and JAX
routes); the port reads JAX bytes back to the same request, skips unknown
fields and fails where protobuf fails on truncated input.  HPACK: RFC
7541's Appendix C header blocks, its Huffman vectors, and a round trip."""

import asyncio
import json
import math
import random

import numpy as np
import pytest
from google.protobuf import descriptor as gdesc
from google.protobuf import empty_pb2, struct_pb2, timestamp_pb2
from google.protobuf.message import DecodeError
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from marie_tpu.proto import docarray_pb2, marie_pb2
from marie_tpu.types.docs import Document as JDocument
from marie_tpu.types.request import DataRequest as JDataRequest
from marie_tpu.types.request import from_request_list_bytes as jfrom_list
from marie_tpu.types.request import to_request_list_bytes as jto_list
from marie_tpu.types.request import ts_iso as jts_iso
from marie_tpu_torch.proto import messages, wire
from marie_tpu_torch.serve.networking import grpc_wire as gw
from marie_tpu_torch.types.docs import Document
from marie_tpu_torch.types.request import DataRequest, from_request_list_bytes, \
    to_request_list_bytes

# derandomized: the same examples on every run and every worker
SETTINGS = settings(max_examples=100, deadline=None, derandomize=True,
                    suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large])


# --- the field tables ---------------------------------------------------------
def _pb_class(name):
    pkg, _, rest = name.partition(".")
    if name.startswith("google.protobuf."):
        mod = {"Struct": struct_pb2, "Value": struct_pb2, "ListValue": struct_pb2,
               "Timestamp": timestamp_pb2, "Empty": empty_pb2}[name.split(".")[-1]]
        return getattr(mod, name.split(".")[-1])
    mod = marie_pb2 if pkg == "jina" else docarray_pb2
    obj = mod
    for part in rest.split("."):
        obj = getattr(obj, part)
    return obj


_PB_SCHEMAS = sorted(n for n in messages.SCHEMAS if not n.startswith("grpc."))
_TYPES = {gdesc.FieldDescriptor.TYPE_STRING: "string", gdesc.FieldDescriptor.TYPE_BYTES: "bytes",
          gdesc.FieldDescriptor.TYPE_BOOL: "bool", gdesc.FieldDescriptor.TYPE_INT32: "int32",
          gdesc.FieldDescriptor.TYPE_INT64: "int64", gdesc.FieldDescriptor.TYPE_UINT32: "uint32",
          gdesc.FieldDescriptor.TYPE_UINT64: "uint64", gdesc.FieldDescriptor.TYPE_DOUBLE: "double",
          gdesc.FieldDescriptor.TYPE_FLOAT: "float", gdesc.FieldDescriptor.TYPE_ENUM: "enum"}


def _pb_type(f):
    if f.message_type is not None:
        return f.message_type.full_name
    return _TYPES[f.type]


def test_field_tables_match_the_descriptors():
    """Every message of both proto files and of google.protobuf's
    well-known types: the same fields, types, labels and oneofs."""
    covered = set()
    for name in _PB_SCHEMAS:
        desc = _pb_class(name).DESCRIPTOR
        assert desc.full_name == name
        want = []
        for f in desc.fields:
            if f.message_type is not None and f.message_type.GetOptions().map_entry:
                kf, vf = f.message_type.fields_by_name["key"], f.message_type.fields_by_name["value"]
                want.append((f.number, f.name, "m", (_pb_type(kf), _pb_type(vf))))
                continue
            oneof = f.containing_oneof
            if f.is_repeated:
                kind = "r"
            elif oneof is not None and not oneof.name.startswith("_"):
                kind = "1" + oneof.name
            elif f.has_presence and f.message_type is None:
                kind = "o"
            else:
                kind = "s"
            want.append((f.number, f.name, kind, _pb_type(f)))
        assert sorted(want) == messages.SCHEMAS[name], name
        covered.add(desc.file.name)
    for mod in (marie_pb2, docarray_pb2):
        names = {m.full_name for m in mod.DESCRIPTOR.message_types_by_name.values()}
        nested = {n.full_name for m in mod.DESCRIPTOR.message_types_by_name.values()
                  for n in m.nested_types if not n.GetOptions().map_entry}
        assert names | nested <= set(messages.SCHEMAS), (names | nested) - set(messages.SCHEMAS)


def _random_value(rng, ftype, depth):
    if ftype in messages.SCHEMAS:
        return _random_message(rng, ftype, depth + 1)
    if ftype == "string":
        return rng.choice(["", "a", "héllo", "ключ", "x" * 40, "☃z"])
    if ftype == "bytes":
        return bytes(rng.randrange(256) for _ in range(rng.choice([0, 1, 5, 33])))
    if ftype == "bool":
        return rng.random() < 0.5
    if ftype in ("int32", "enum"):
        return rng.choice([0, 1, -1, 2 ** 31 - 1, -2 ** 31, rng.randrange(-999, 999)])
    if ftype == "int64":
        return rng.choice([0, 1, -1, 2 ** 63 - 1, -2 ** 63, rng.randrange(-10 ** 12, 10 ** 12)])
    if ftype == "uint32":
        return rng.choice([0, 1, 2 ** 32 - 1, rng.randrange(10 ** 6)])
    if ftype == "uint64":
        return rng.choice([0, 2 ** 64 - 1, rng.randrange(10 ** 12)])
    return rng.choice([0.0, -0.0, 1.5, -2.25e-300, 1e308, rng.random()])


def _random_message(rng, name, depth=0):
    out = {}
    oneofs = {}
    for number, fname, kind, ftype in messages.SCHEMAS[name]:
        if depth > 3 or rng.random() < 0.4:
            continue
        if kind.startswith("1"):
            oneofs.setdefault(kind, []).append((fname, ftype))
            continue
        if kind == "r":
            out[fname] = [_random_value(rng, ftype, depth) for _ in range(rng.choice([0, 1, 3]))]
        elif kind == "m":
            out[fname] = {_random_value(rng, ftype[0], depth): _random_value(rng, ftype[1], depth)
                          for _ in range(rng.choice([0, 1, 3]))}
        else:
            out[fname] = _random_value(rng, ftype, depth)
    for members in oneofs.values():
        fname, ftype = rng.choice(members)
        out[fname] = _random_value(rng, ftype, depth)
    return out


@pytest.mark.parametrize("name", _PB_SCHEMAS)
def test_random_messages_encode_as_protobuf_and_decode_back(name):
    """For 60 random messages of each schema: protobuf parses the port's
    bytes and writes them again unchanged (deterministic), the port reads
    protobuf's bytes back to the same encoding, and every strict prefix
    that protobuf refuses the port refuses too."""
    rng = random.Random(name)
    cls = _pb_class(name)
    for _ in range(60):
        raw = messages.encode(name, _random_message(rng, name))
        pb = cls()
        pb.ParseFromString(raw)
        assert pb.SerializeToString(deterministic=True) == raw
        assert messages.encode(name, messages.decode(name, raw)) == raw
        for cut in sorted({rng.randrange(len(raw)) for _ in range(8)} if raw else ()):
            try:
                cls().ParseFromString(raw[:cut])
                pb_ok = True
            except DecodeError:
                pb_ok = False
            try:
                messages.decode(name, raw[:cut])
                ok = True
            except ValueError:
                ok = False
            assert ok == pb_ok, (name, cut)


def test_wire_primitives():
    out = bytearray()
    wire.write_varint(out, -1)
    assert bytes(out) == b"\xff" * 9 + b"\x01"
    assert wire.to_int32(wire.read_varint(bytes(out), 0)[0]) == -1
    with pytest.raises(ValueError):
        wire.read_varint(b"\x80\x80", 0)
    with pytest.raises(ValueError):
        wire.read_varint(b"\xff" * 11, 0)
    # the JAX module's dict-of-numbers form round-trips
    msg = {1: 5, 2: b"ab", 3: {1: 7}, 4: [1, 2]}
    back = wire.decode(wire.encode(msg))
    assert back[1] == [5] and back[2] == [b"ab"] and wire.decode(back[3][0]) == {1: [7]}
    # packed and unpacked repeated fields read the same
    packed = messages.encode("docarray.DenseNdArrayProto", {"shape": [3, 300, 0]})
    unpacked = b"".join(bytes([0x10]) + bytes(_varint(v)) for v in (3, 300, 0))
    assert messages.decode("docarray.DenseNdArrayProto", packed)["shape"] == [3, 300, 0]
    assert messages.decode("docarray.DenseNdArrayProto", unpacked)["shape"] == [3, 300, 0]


def _varint(v):
    out = bytearray()
    wire.write_varint(out, v)
    return out


# --- DataRequest against the JAX request ----------------------------------
_KEYS = st.text(min_size=0, max_size=6)
_SCALARS = st.one_of(st.none(), st.booleans(), st.integers(-2 ** 40, 2 ** 40),
                     st.floats(allow_nan=False, allow_infinity=False),
                     st.sampled_from([0.0, -0.0]), st.text(max_size=8))
_JSON = st.recursive(_SCALARS, lambda c: st.one_of(
    st.lists(c, max_size=3), st.dictionaries(_KEYS, c, max_size=3)), max_leaves=8)
# tags: the docarray conversion reads a dict with an "id" key as a nested
# document, so draw both kinds
_TAG_KEYS = st.one_of(_KEYS, st.just("id"))
_TAGS = st.dictionaries(_TAG_KEYS, st.recursive(_SCALARS, lambda c: st.one_of(
    st.lists(c, max_size=3), st.dictionaries(_TAG_KEYS, c, max_size=3)), max_leaves=6),
    max_size=4)
_DTYPES = st.sampled_from(["float32", "float64", "int64", "uint8", "int16", "bool"])


@st.composite
def _doc_specs(draw, depth=0):
    spec = {"id": draw(st.text(min_size=1, max_size=8))}
    if draw(st.booleans()):
        spec["text"] = draw(st.text(max_size=12))
    if draw(st.booleans()):
        spec["tags"] = draw(_TAGS)
    if draw(st.booleans()):
        shape = draw(st.lists(st.integers(0, 3), min_size=1, max_size=3))
        spec["tensor"] = (draw(_DTYPES), shape, draw(st.integers(0, 99)))
    if draw(st.booleans()):
        spec["blob"] = draw(st.binary(max_size=16))
    if draw(st.booleans()):
        spec["scores"] = draw(st.dictionaries(_KEYS, st.floats(-10, 10), max_size=2))
    if depth == 0 and draw(st.booleans()):
        spec["chunks"] = draw(st.lists(_doc_specs(depth=1), max_size=2))
    if depth == 0 and draw(st.booleans()):
        spec["matches"] = draw(st.lists(_doc_specs(depth=1), max_size=1))
    return spec


def _make_doc(cls, spec):
    kw = dict(spec)
    if "tensor" in kw:
        dtype, shape, seed = kw["tensor"]
        kw["tensor"] = (np.random.default_rng(seed).standard_normal(shape) * 50).astype(dtype)
    for key in ("chunks", "matches"):
        if key in kw:
            kw[key] = [_make_doc(cls, s) for s in kw[key]]
    if "tags" in kw:
        kw["tags"] = json.loads(json.dumps(kw["tags"]))
    return cls(**kw)


_TIMES = st.datetimes(min_value=__import__("datetime").datetime(1971, 1, 1),
                      max_value=__import__("datetime").datetime(2200, 1, 1))


@st.composite
def _requests(draw):
    return {
        "docs": draw(st.lists(_doc_specs(), max_size=3)),
        "mode": draw(st.sampled_from(["docs_bytes", "docs"])),
        "params": draw(st.one_of(st.none(), st.dictionaries(_KEYS, _JSON, max_size=4))),
        "endpoint": draw(st.one_of(st.none(), st.sampled_from(["", "/", "/extract", "/é"]))),
        "target": draw(st.one_of(st.none(), st.sampled_from(["", "ex.*"]))),
        "timeout": draw(st.one_of(st.none(), st.integers(0, 2 ** 32 - 1))),
        "routes": draw(st.lists(st.tuples(st.text(max_size=5), _TIMES, _TIMES), max_size=2)),
        "error": draw(st.booleans()),
        "read_params": draw(st.booleans()),
    }


def _build(side, spec):
    """The same request in each package."""
    R, D = (JDataRequest, JDocument) if side == "jax" else (DataRequest, Document)
    r = R()
    r.request_id = "rid-1"
    r.docs = [_make_doc(D, s) for s in spec["docs"]]
    r.wire_mode = spec["mode"]
    if spec["params"] is not None:
        r.parameters = spec["params"]
    elif spec["read_params"]:
        _ = r.parameters
    for key, value in (("exec_endpoint", spec["endpoint"]), ("target_executor", spec["target"]),
                       ("timeout", spec["timeout"])):
        if value is not None:
            setattr(r.proto.header if side == "jax" else r.header, key, value)
    for name, start, end in spec["routes"]:
        r.add_route(name, start.isoformat(), end.isoformat() + "+02:00")
    if spec["error"]:
        try:
            raise ValueError("boom", 3)
        except ValueError as ex:
            r.add_exception(ex, "exec")
        stacks = ["stack line"]
        if side == "jax":
            r.proto.header.status.exception.stacks[:] = stacks
        else:
            r.status.exception.stacks = stacks
    return r


def _docs_json(docs):
    return [json.loads(d.to_json()) for d in docs]


@SETTINGS
@given(_requests())
def test_request_bytes_equal_jax(spec):
    """to_bytes and to_request_list_bytes are the JAX request's bytes; each
    package reads the other's bytes to the same request and writes them
    again unchanged, before and after decoding the docs and parameters."""
    j, t = _build("jax", spec), _build("port", spec)
    jb, tb = j.to_bytes(), t.to_bytes()
    assert tb == jb
    assert to_request_list_bytes([_build("port", spec)] * 2) == jto_list([_build("jax", spec)] * 2)
    back = DataRequest.from_bytes(jb)
    assert back.to_bytes() == jb  # undecoded content goes back as it came
    jback = JDataRequest.from_bytes(jb)
    assert back.request_id == jback.request_id
    assert back.header.exec_endpoint == (jback.proto.header.exec_endpoint
                                         if jback.proto.header.HasField("exec_endpoint") else None)
    assert back.header.timeout == (jback.proto.header.timeout
                                   if jback.proto.header.HasField("timeout") else None)
    assert back.parameters == jback.parameters
    assert back.wire_mode == jback.wire_mode
    assert [(r.executor, r.start_time, r.end_time) for r in back.routes] == [
        (r.executor, jts_iso(r.start_time), jts_iso(r.end_time)) for r in jback.routes]
    assert back.is_error() == jback.is_error()
    assert back.status.exception.args == list(jback.proto.header.status.exception.args)
    lst = from_request_list_bytes(jto_list([j, j]))
    assert [r.to_bytes() for r in lst] == [r.to_bytes() for r in jfrom_list(jto_list([j, j]))]
    try:
        want_docs = _docs_json(jback.docs)
    except ValueError:
        # a tag {"id": None} reads back as a nested document with no fields,
        # that is None, which neither package's Document takes
        with pytest.raises((TypeError, ValueError)):
            back.docs
        return
    assert _docs_json(back.docs) == want_docs
    # decoded, then written again: still what JAX writes
    assert back.to_bytes() == jback.to_bytes()


def test_unknown_fields_are_skipped_and_truncation_raises():
    j = _build("jax", {"docs": [{"id": "a", "text": "x", "tags": {"k": [1, "b"]}}],
                       "mode": "docs", "params": {"p": 1}, "endpoint": "/e", "target": None,
                       "timeout": 5, "routes": [], "error": False, "read_params": False})
    jb = j.to_bytes()
    unknown = bytearray()
    wire.write_tag(unknown, 99, wire.VARINT)
    wire.write_varint(unknown, 123456)
    wire.write_float(unknown, 98, 1.5)
    wire.write_double(unknown, 97, -2.0)
    wire.write_len(unknown, 96, b"whatever")
    header = messages.encode("jina.HeaderProto", {"request_id": "rid-1"}) + bytes(unknown)
    noisy = bytearray(unknown) + jb
    wire.write_len(noisy, 1, header)  # a second header merges into the first
    noisy = bytes(noisy)
    pb = marie_pb2.DataRequestProto()
    pb.ParseFromString(noisy)  # protobuf takes it
    back = DataRequest.from_bytes(noisy)
    assert back.to_bytes() == jb
    assert back.parameters == {"p": 1.0} and back.docs[0].tags == {"k": [1, "b"]}
    for cut in (1, len(jb) // 2, len(jb) - 1):
        with pytest.raises(DecodeError):
            marie_pb2.DataRequestProto().ParseFromString(jb[:cut])
        with pytest.raises(ValueError):
            DataRequest.from_bytes(jb[:cut])
    with pytest.raises(ValueError):
        messages.decode("jina.DataRequestProto", b"\x0b")  # wire type 3 (a group)


def test_struct_conversion_matches_json_format():
    from google.protobuf import json_format

    value = {"a": 1, "b": [1.5, None, True, "x", {}, []], "c": {"z": 0, "y": -0.0},
             "big": 2 ** 60, "u": "ключ"}
    s = struct_pb2.Struct()
    json_format.ParseDict(value, s)
    raw = messages.encode("google.protobuf.Struct", messages.py_to_struct(value))
    assert raw == s.SerializeToString(deterministic=True)
    got = messages.struct_to_py(messages.decode("google.protobuf.Struct", raw))
    want = json_format.MessageToDict(s)
    assert got == want and math.copysign(1, got["c"]["y"]) < 0
    assert all(isinstance(v, float) for v in (got["a"], got["big"]))


# --- HPACK -------------------------------------------------------------------
_C3 = [  # RFC 7541 C.3: requests without Huffman, one dynamic table
    ("828684410f7777772e6578616d706c652e636f6d",
     [(":method", "GET"), (":scheme", "http"), (":path", "/"), (":authority", "www.example.com")],
     57),
    ("828684be58086e6f2d6361636865",
     [(":method", "GET"), (":scheme", "http"), (":path", "/"), (":authority", "www.example.com"),
      ("cache-control", "no-cache")], 110),
    ("828785bf400a637573746f6d2d6b65790c637573746f6d2d76616c7565",
     [(":method", "GET"), (":scheme", "https"), (":path", "/index.html"),
      (":authority", "www.example.com"), ("custom-key", "custom-value")], 164),
]
_C4 = [  # RFC 7541 C.4: the same requests with Huffman coding
    "828684418cf1e3c2e5f23a6ba0ab90f4ff", "828684be5886a8eb10649cbf",
    "828785bf408825a849e95ba97d7f8925a849e95bb8e8b4bf",
]


def test_hpack_decodes_the_rfc_examples():
    plain, huff = gw.HpackDecoder(), gw.HpackDecoder()
    for (raw, headers, size), hraw in zip(_C3, _C4):
        assert plain.decode(bytes.fromhex(raw)) == headers
        assert huff.decode(bytes.fromhex(hraw)) == headers
        assert plain.size == huff.size == size
    assert plain.table == [("custom-key", "custom-value"), ("cache-control", "no-cache"),
                           (":authority", "www.example.com")]
    small = gw.HpackDecoder()
    small.decode(bytes([0x20 | 0]))  # a size update to 0 empties the table
    assert small.max_size == 0
    with pytest.raises(gw.ConnectionError_):
        gw.HpackDecoder(4096).decode(bytes([0x3F, 0xE1, 0xFF, 0x03]))  # over the limit


@settings(max_examples=100, deadline=None, derandomize=True)
@given(st.binary(max_size=64))
def test_huffman_round_trip(data):
    assert gw.huffman_decode(gw.huffman_encode(data)) == data


def test_huffman_vectors_and_headers_round_trip():
    vectors = {"www.example.com": "f1e3c2e5f23a6ba0ab90f4ff", "no-cache": "a8eb10649cbf",
               "custom-value": "25a849e95bb8e8b4bf", "302": "6402", "private": "aec3771a4b",
               "Mon, 21 Oct 2013 20:13:21 GMT": "d07abe941054d444a8200595040b8166e082a62d1bff",
               "https://www.example.com": "9d29ad171863c78f0b97c8e9ae82ae43d3", "gzip": "9bd9ab"}
    for text, code in vectors.items():
        assert gw.huffman_encode(text.encode()).hex() == code
        assert gw.huffman_decode(bytes.fromhex(code)) == text.encode()
    with pytest.raises(gw.ConnectionError_):
        gw.huffman_decode(b"\x00")  # padding that is not EOS's ones
    headers = [(":status", "200"), ("content-type", "application/grpc"),
               ("grpc-message", gw.percent_encode("über 100% fail\n")), ("x-k", "v" * 300)]
    assert gw.HpackDecoder().decode(gw.encode_headers(headers)) == headers
    assert gw.percent_decode(headers[2][1]) == "über 100% fail\n"
    assert gw.parse_timeout(gw.encode_timeout(1.5)) == pytest.approx(1.5)
    assert gw.encode_timeout(1e9).endswith("S") or gw.encode_timeout(1e9).endswith("M")


# --- HTTP/2 framing, by hand -------------------------------------------------
def _frame(ftype, flags, sid, payload=b""):
    return len(payload).to_bytes(3, "big") + bytes([ftype, flags]) + sid.to_bytes(4, "big") \
        + payload


async def _read_frames(reader, until_sid_end):
    """Frames until stream ``until_sid_end`` ends: [(type, flags, sid, payload)]."""
    frames = []
    while True:
        head = await asyncio.wait_for(reader.readexactly(9), 10)
        n = int.from_bytes(head[:3], "big")
        payload = await reader.readexactly(n) if n else b""
        frames.append((head[3], head[4], int.from_bytes(head[5:9], "big"), payload))
        if frames[-1][2] == until_sid_end and frames[-1][1] & gw.END_STREAM and \
                frames[-1][0] in (gw.HEADERS, gw.DATA):
            return frames


def test_raw_frames_continuation_padding_ping_and_trailers():
    """A client written by hand: the server answers a request whose header
    block (Huffman-coded values, a dynamic-table entry) spans HEADERS and
    CONTINUATION and whose DATA is padded; it ACKs SETTINGS and PING,
    raises the connection window, answers an unknown method and an abort
    Trailers-Only with a percent-encoded message, and says GOAWAY on a
    frame that breaks the protocol."""
    async def echo(req, ctx):
        return req[::-1]

    async def fail(req, ctx):
        await ctx.abort(gw.StatusCode.NOT_FOUND, "nein: 100% ü")

    async def run():
        srv = gw.Server()
        srv.add_method("/t.S/echo", gw.UNARY_UNARY, echo)
        srv.add_method("/t.S/fail", gw.UNARY_UNARY, fail)
        port = await srv.start("127.0.0.1", 0)
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(gw.PREFACE + _frame(gw.SETTINGS, 0, 0))
        huff = gw.huffman_encode(b"/t.S/echo")
        block = (bytes([0x83, 0x86]) + bytes([0x44, 0x80 | len(huff)]) + huff
                 + gw.encode_headers([(":authority", "x"), ("content-type", "application/grpc"),
                                      ("te", "trailers")])
                 + bytes([0x40, 3]) + b"x-k" + bytes([3]) + b"v-1")  # indexed: x-k: v-1
        writer.write(_frame(gw.HEADERS, 0, 1, block[:7]) + _frame(gw.CONTINUATION, 0, 1, block[7:15])
                     + _frame(gw.CONTINUATION, gw.END_HEADERS, 1, block[15:]))
        msg = gw.frame_message(b"hello")
        writer.write(_frame(gw.DATA, gw.PADDED | gw.END_STREAM, 1, bytes([3]) + msg + b"\0\0\0"))
        writer.write(_frame(gw.PING, 0, 0, b"12345678"))
        frames = await _read_frames(reader, 1)
        # the same dynamic-table entry, by index (62), on a second stream
        block2 = bytes([0x83, 0x86, 0x04, 9]) + b"/t.S/fail" + gw.encode_headers(
            [("content-type", "application/grpc")]) + bytes([0x80 | 62])
        writer.write(_frame(gw.HEADERS, gw.END_HEADERS, 3, block2)
                     + _frame(gw.DATA, gw.END_STREAM, 3, msg))
        frames += await _read_frames(reader, 3)
        writer.write(_frame(gw.HEADERS, gw.END_HEADERS | gw.END_STREAM, 5, bytes([0x83, 0x86])
                            + bytes([0x04, 3]) + b"/no" + gw.encode_headers(
                                [("content-type", "application/grpc")])))
        frames += await _read_frames(reader, 5)
        writer.write(_frame(gw.DATA, 0, 0, b"x"))  # DATA on stream 0: a protocol error
        frames.append(await asyncio.wait_for(reader.read(1 << 16), 10))
        writer.close()
        await srv.stop()
        return frames

    frames = asyncio.run(run())
    tail = frames.pop()
    dec = gw.HpackDecoder()
    by = {}
    for ftype, flags, sid, payload in frames:
        if ftype == gw.HEADERS:
            by.setdefault(sid, []).append(dict(dec.decode(payload)))
        elif ftype == gw.DATA and sid == 1:
            by.setdefault("data", b"")
            by["data"] += payload
    kinds = [(f[0], f[1]) for f in frames if f[2] == 0]
    assert (gw.SETTINGS, 0) in kinds and (gw.SETTINGS, gw.ACK) in kinds
    assert (gw.PING, gw.ACK) in kinds and (gw.WINDOW_UPDATE, 0) in kinds
    assert by["data"] == gw.frame_message(b"olleh")
    assert by[1][0][":status"] == "200" and by[1][-1]["grpc-status"] == "0"
    assert len(by[3]) == 1 and by[3][0]["grpc-status"] == str(int(gw.StatusCode.NOT_FOUND))
    assert gw.percent_decode(by[3][0]["grpc-message"]) == "nein: 100% ü"
    assert by[5][0]["grpc-status"] == str(int(gw.StatusCode.UNIMPLEMENTED))
    assert tail[3] == gw.GOAWAY and int.from_bytes(tail[13:17], "big") == gw.PROTOCOL_ERROR
