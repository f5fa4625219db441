"""gRPC over HTTP/2 on ``asyncio``, written on the standard library: the
part of the serving plane that ``grpcio`` is in the JAX package (the
card's machine has no ``grpcio``).

HTTP/2 (RFC 9113): the connection preface, SETTINGS and their ACK, PING
ACK, GOAWAY, RST_STREAM, HEADERS with CONTINUATION, and flow control on
the stream and connection windows both ways: DATA is split at the peer's
``SETTINGS_MAX_FRAME_SIZE`` and waits for its windows; a WINDOW_UPDATE
goes back as received data is taken off the connection.  HPACK (RFC
7541): the static table, the dynamic table with its size updates, and
Huffman decoding; this side sends literals without indexing, so it keeps
no encoder state.  gRPC (``PROTOCOL-HTTP2.md``): the 5-byte message prefix
and a message limit (RESOURCE_EXHAUSTED past it), ``grpc-encoding``
``gzip`` and ``deflate`` by ``zlib``, ``grpc-timeout`` (DEADLINE_EXCEEDED),
trailers with ``grpc-status`` and a percent-encoded ``grpc-message``
(Trailers-Only for an early error), RST_STREAM(CANCEL) cancelling the
server's handler task, and unary, server-streaming and bidirectional
calls, any number of them on one connection.

:class:`Server` serves handlers by method path; :class:`Channel` is the
client side, one connection made on first use and made again after it
is lost.  Messages are bytes here; the servers and clients above encode
them (:mod:`marie_tpu_torch.proto.messages`).
"""

import asyncio
import enum
import re
import zlib
from typing import AsyncIterator, Callable, Dict, List, Optional, Sequence, Tuple
from urllib.parse import unquote_to_bytes

#: the largest message either side takes (``grpc_server.py``'s _MAX_MSG)
MAX_MESSAGE = 64 * 1024 * 1024

PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"

# frame types and flags
DATA, HEADERS, PRIORITY, RST_STREAM, SETTINGS, PUSH_PROMISE, PING, GOAWAY, WINDOW_UPDATE, \
    CONTINUATION = range(10)
END_STREAM, ACK, END_HEADERS, PADDED, PRIORITY_FLAG = 0x1, 0x1, 0x4, 0x8, 0x20

# settings
S_HEADER_TABLE_SIZE, S_ENABLE_PUSH, S_MAX_CONCURRENT_STREAMS, S_INITIAL_WINDOW_SIZE, \
    S_MAX_FRAME_SIZE, S_MAX_HEADER_LIST_SIZE = range(1, 7)

# error codes
NO_ERROR, PROTOCOL_ERROR, INTERNAL_ERROR, FLOW_CONTROL_ERROR, SETTINGS_TIMEOUT, \
    STREAM_CLOSED, FRAME_SIZE_ERROR, REFUSED_STREAM, CANCEL, COMPRESSION_ERROR = range(10)

DEFAULT_WINDOW = 65535
DEFAULT_MAX_FRAME = 16384
#: what this side advertises: the stream window, the connection window it
#: raises its own to at once, and the largest frame it takes
LOCAL_STREAM_WINDOW = 4 << 20
LOCAL_CONN_WINDOW = 16 << 20
LOCAL_MAX_FRAME = 1 << 20
_MAX_HEADER_BLOCK = 8 << 20


class StatusCode(enum.IntEnum):
    """gRPC status codes."""

    OK = 0
    CANCELLED = 1
    UNKNOWN = 2
    INVALID_ARGUMENT = 3
    DEADLINE_EXCEEDED = 4
    NOT_FOUND = 5
    ALREADY_EXISTS = 6
    PERMISSION_DENIED = 7
    RESOURCE_EXHAUSTED = 8
    FAILED_PRECONDITION = 9
    ABORTED = 10
    OUT_OF_RANGE = 11
    UNIMPLEMENTED = 12
    INTERNAL = 13
    UNAVAILABLE = 14
    DATA_LOSS = 15
    UNAUTHENTICATED = 16


class RpcError(Exception):
    """A call that ended with a status other than OK (``grpc.aio.AioRpcError``'s
    ``code()`` and ``details()``)."""

    def __init__(self, code: StatusCode, details: str = ""):
        super().__init__(f"{StatusCode(code).name}: {details}")
        self._code = StatusCode(code)
        self._details = details

    def code(self) -> StatusCode:
        return self._code

    def details(self) -> str:
        return self._details


class ConnectionError_(Exception):
    """An HTTP/2 protocol fault: the connection is closed with GOAWAY."""

    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.error_code = code


# --- HPACK -----------------------------------------------------------------
STATIC_TABLE: Tuple[Tuple[str, str], ...] = (
    (":authority", ""), (":method", "GET"), (":method", "POST"), (":path", "/"),
    (":path", "/index.html"), (":scheme", "http"), (":scheme", "https"), (":status", "200"),
    (":status", "204"), (":status", "206"), (":status", "304"), (":status", "400"),
    (":status", "404"), (":status", "500"), ("accept-charset", ""),
    ("accept-encoding", "gzip, deflate"), ("accept-language", ""), ("accept-ranges", ""),
    ("accept", ""), ("access-control-allow-origin", ""), ("age", ""), ("allow", ""),
    ("authorization", ""), ("cache-control", ""), ("content-disposition", ""),
    ("content-encoding", ""), ("content-language", ""), ("content-length", ""),
    ("content-location", ""), ("content-range", ""), ("content-type", ""), ("cookie", ""),
    ("date", ""), ("etag", ""), ("expect", ""), ("expires", ""), ("from", ""), ("host", ""),
    ("if-match", ""), ("if-modified-since", ""), ("if-none-match", ""), ("if-range", ""),
    ("if-unmodified-since", ""), ("last-modified", ""), ("link", ""), ("location", ""),
    ("max-forwards", ""), ("proxy-authenticate", ""), ("proxy-authorization", ""),
    ("range", ""), ("referer", ""), ("refresh", ""), ("retry-after", ""), ("server", ""),
    ("set-cookie", ""), ("strict-transport-security", ""), ("transfer-encoding", ""),
    ("user-agent", ""), ("vary", ""), ("via", ""), ("www-authenticate", ""))
_STATIC_FULL = {entry: i + 1 for i, entry in reversed(list(enumerate(STATIC_TABLE)))}
_STATIC_NAME = {name: i + 1 for i, (name, _) in reversed(list(enumerate(STATIC_TABLE)))}

#: bit lengths of the HPACK Huffman code of symbols 0..255 and EOS (256),
#: RFC 7541 Appendix B; the code is canonical, so the lengths define it
HUFFMAN_LENGTHS = (
    13, 23, 28, 28, 28, 28, 28, 28, 28, 24, 30, 28, 28, 30, 28, 28,
    28, 28, 28, 28, 28, 28, 30, 28, 28, 28, 28, 28, 28, 28, 28, 28,
    6, 10, 10, 12, 13, 6, 8, 11, 10, 10, 8, 11, 8, 6, 6, 6,
    5, 5, 5, 6, 6, 6, 6, 6, 6, 6, 7, 8, 15, 6, 12, 10,
    13, 6, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7,
    7, 7, 7, 7, 7, 7, 7, 7, 8, 7, 8, 13, 19, 13, 14, 6,
    15, 5, 6, 5, 6, 5, 6, 6, 6, 5, 7, 7, 6, 6, 6, 5,
    6, 7, 6, 5, 5, 6, 7, 7, 7, 7, 7, 15, 11, 14, 13, 28,
    20, 22, 20, 20, 22, 22, 22, 23, 22, 23, 23, 23, 23, 23, 24, 23,
    24, 24, 22, 23, 24, 23, 23, 23, 23, 21, 22, 23, 22, 23, 23, 24,
    22, 21, 20, 22, 22, 23, 23, 21, 23, 22, 22, 24, 21, 22, 23, 23,
    21, 21, 22, 21, 23, 22, 23, 23, 20, 22, 22, 22, 23, 22, 22, 23,
    26, 26, 20, 19, 22, 23, 22, 25, 26, 26, 26, 27, 27, 26, 24, 25,
    19, 21, 26, 27, 27, 26, 27, 24, 21, 21, 26, 26, 28, 27, 27, 27,
    20, 24, 20, 21, 22, 21, 21, 23, 22, 22, 25, 25, 24, 24, 26, 23,
    26, 27, 26, 26, 27, 27, 27, 27, 27, 28, 27, 27, 27, 27, 27, 26,
    30)


def _canonical_codes(lengths: Sequence[int]) -> List[int]:
    """The canonical code of each symbol: by length, then by symbol."""
    codes = [0] * len(lengths)
    code, prev = 0, 0
    for length, sym in sorted((n, s) for s, n in enumerate(lengths)):
        code <<= length - prev
        codes[sym] = code
        code += 1
        prev = length
    return codes


HUFFMAN_CODES = _canonical_codes(HUFFMAN_LENGTHS)
_HUFFMAN_DECODE = {(n, c): s for s, (n, c) in enumerate(zip(HUFFMAN_LENGTHS, HUFFMAN_CODES))}
_HUFFMAN_MIN = min(HUFFMAN_LENGTHS)


def huffman_decode(data: bytes) -> bytes:
    """Decode a Huffman-coded HPACK string; the padding must be the EOS
    code's leading ones, under 8 bits (RFC 7541 5.2)."""
    out = bytearray()
    code, n = 0, 0
    for byte in data:
        for shift in range(7, -1, -1):
            code = (code << 1) | ((byte >> shift) & 1)
            n += 1
            if n >= _HUFFMAN_MIN:
                sym = _HUFFMAN_DECODE.get((n, code))
                if sym is not None:
                    if sym == 256:
                        raise ConnectionError_(COMPRESSION_ERROR, "EOS in a Huffman string")
                    out.append(sym)
                    code, n = 0, 0
                elif n > 30:
                    raise ConnectionError_(COMPRESSION_ERROR, "bad Huffman code")
    if n >= 8 or code != (1 << n) - 1:
        raise ConnectionError_(COMPRESSION_ERROR, "bad Huffman padding")
    return bytes(out)


def huffman_encode(data: bytes) -> bytes:
    """Huffman-code ``data`` (padded with EOS's leading ones)."""
    acc, n = 0, 0
    for byte in data:
        acc = (acc << HUFFMAN_LENGTHS[byte]) | HUFFMAN_CODES[byte]
        n += HUFFMAN_LENGTHS[byte]
    pad = -n % 8
    acc = (acc << pad) | ((1 << pad) - 1)
    return acc.to_bytes((n + pad) // 8, "big")


def _encode_int(value: int, prefix: int, first: int) -> bytearray:
    """An HPACK integer with a ``prefix``-bit prefix; ``first`` carries the
    high bits of the first byte."""
    limit = (1 << prefix) - 1
    if value < limit:
        return bytearray([first | value])
    out = bytearray([first | limit])
    value -= limit
    while value >= 128:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return out


def _decode_int(data: bytes, pos: int, prefix: int) -> Tuple[int, int]:
    limit = (1 << prefix) - 1
    if pos >= len(data):
        raise ConnectionError_(COMPRESSION_ERROR, "truncated header block")
    value = data[pos] & limit
    pos += 1
    if value < limit:
        return value, pos
    shift = 0
    while True:
        if pos >= len(data) or shift > 28:
            raise ConnectionError_(COMPRESSION_ERROR, "bad HPACK integer")
        b = data[pos]
        pos += 1
        value += (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return value, pos


def _encode_str(s: str) -> bytearray:
    raw = s.encode("latin-1" if s.isascii() else "utf-8")
    out = _encode_int(len(raw), 7, 0)
    out += raw
    return out


def encode_headers(headers: Sequence[Tuple[str, str]]) -> bytes:
    """An HPACK header block: static-table entries indexed, everything else
    a literal without indexing (so no encoder state on either side)."""
    out = bytearray()
    for name, value in headers:
        idx = _STATIC_FULL.get((name, value))
        if idx is not None:
            out += _encode_int(idx, 7, 0x80)
            continue
        idx = _STATIC_NAME.get(name)
        if idx is not None:
            out += _encode_int(idx, 4, 0x00)
        else:
            out += _encode_int(0, 4, 0x00)
            out += _encode_str(name)
        out += _encode_str(value)
    return bytes(out)


class HpackDecoder:
    """HPACK decoding with the dynamic table (one per connection)."""

    def __init__(self, max_table_size: int = 4096):
        self.max_allowed = max_table_size  # what this side advertised
        self.max_size = max_table_size
        self.size = 0
        self.table: List[Tuple[str, str]] = []  # newest first

    def _entry(self, index: int) -> Tuple[str, str]:
        if index <= 0:
            raise ConnectionError_(COMPRESSION_ERROR, "header index 0")
        if index <= len(STATIC_TABLE):
            return STATIC_TABLE[index - 1]
        i = index - len(STATIC_TABLE) - 1
        if i >= len(self.table):
            raise ConnectionError_(COMPRESSION_ERROR, f"header index {index} past the table")
        return self.table[i]

    def _evict(self) -> None:
        while self.size > self.max_size and self.table:
            name, value = self.table.pop()
            self.size -= len(name) + len(value) + 32

    def _add(self, name: str, value: str) -> None:
        self.table.insert(0, (name, value))
        self.size += len(name) + len(value) + 32
        self._evict()

    @staticmethod
    def _str(data: bytes, pos: int) -> Tuple[str, int]:
        huffman = pos < len(data) and bool(data[pos] & 0x80)
        length, pos = _decode_int(data, pos, 7)
        if pos + length > len(data):
            raise ConnectionError_(COMPRESSION_ERROR, "truncated header string")
        raw = data[pos:pos + length]
        if huffman:
            raw = huffman_decode(raw)
        return raw.decode("utf-8", "surrogateescape"), pos + length

    def decode(self, data: bytes) -> List[Tuple[str, str]]:
        headers: List[Tuple[str, str]] = []
        pos = 0
        while pos < len(data):
            b = data[pos]
            if b & 0x80:  # indexed
                index, pos = _decode_int(data, pos, 7)
                headers.append(self._entry(index))
                continue
            if b & 0xE0 == 0x20:  # dynamic table size update
                size, pos = _decode_int(data, pos, 5)
                if size > self.max_allowed:
                    raise ConnectionError_(COMPRESSION_ERROR, "table size over the limit")
                self.max_size = size
                self._evict()
                continue
            indexing = bool(b & 0x40)
            index, pos = _decode_int(data, pos, 6 if indexing else 4)
            if index:
                name = self._entry(index)[0]
            else:
                name, pos = self._str(data, pos)
            value, pos = self._str(data, pos)
            headers.append((name, value))
            if indexing:
                self._add(name, value)
        return headers


# --- gRPC pieces -------------------------------------------------------------
_ENCODINGS = {"gzip": 31, "deflate": 15}
#: ``grpc.Compression`` names (the JAX servers' and clients' argument) and
#: the encodings they mean
COMPRESSION = {"Gzip": "gzip", "Deflate": "deflate", "NoCompression": None,
               "gzip": "gzip", "deflate": "deflate"}
ACCEPT_ENCODING = "identity,deflate,gzip"
_TIMEOUT_UNITS = {"H": 3600.0, "M": 60.0, "S": 1.0, "m": 1e-3, "u": 1e-6, "n": 1e-9}
_TIMEOUT_RE = re.compile(r"^(\d{1,8})([HMSmun])$")
USER_AGENT = "marie-tpu-torch-grpc/1"
_NOT_METADATA = {"te", "content-type", "grpc-timeout", "grpc-encoding", "grpc-accept-encoding"}


def encode_timeout(seconds: float) -> str:
    """``grpc-timeout``: at most 8 digits, in the finest unit that fits."""
    seconds = max(seconds, 0.0)
    for unit, scale in (("n", 1e-9), ("u", 1e-6), ("m", 1e-3), ("S", 1.0), ("M", 60.0),
                        ("H", 3600.0)):
        value = int(-(-seconds // scale))
        if value < 100_000_000:
            return f"{value}{unit}"
    return "99999999H"


def parse_timeout(value: Optional[str]) -> Optional[float]:
    if not value:
        return None
    m = _TIMEOUT_RE.match(value)
    if m is None:
        raise ValueError(f"bad grpc-timeout {value!r}")
    return int(m.group(1)) * _TIMEOUT_UNITS[m.group(2)]


def percent_encode(message: str) -> str:
    """``grpc-message``: UTF-8 bytes outside 0x20-0x7E, and '%', as %XX."""
    return "".join(chr(b) if 0x20 <= b <= 0x7E and b != 0x25 else f"%{b:02X}"
                   for b in message.encode("utf-8"))


def percent_decode(value: str) -> str:
    return unquote_to_bytes(value).decode("utf-8", "replace")


def compress(data: bytes, encoding: str) -> bytes:
    c = zlib.compressobj(6, zlib.DEFLATED, _ENCODINGS[encoding])
    return c.compress(data) + c.flush()


def decompress(data: bytes, encoding: str, limit: int) -> bytes:
    """Inflate a compressed message, RESOURCE_EXHAUSTED past ``limit``."""
    if encoding not in _ENCODINGS:
        raise RpcError(StatusCode.INTERNAL, f"compressed message without a known "
                                            f"grpc-encoding ({encoding!r})")
    d = zlib.decompressobj(47)  # gzip or zlib, by its header
    try:
        out = d.decompress(data, limit + 1)
    except zlib.error as ex:
        raise RpcError(StatusCode.INTERNAL, f"cannot decompress a message: {ex}")
    if len(out) > limit:
        raise RpcError(StatusCode.RESOURCE_EXHAUSTED,
                       f"decompressed message larger than max ({limit})")
    return out


def frame_message(data: bytes, encoding: Optional[str] = None) -> bytes:
    """gRPC's length-prefixed message: flag, 4-byte length, payload."""
    flag = 0
    if encoding:
        data, flag = compress(data, encoding), 1
    return bytes([flag]) + len(data).to_bytes(4, "big") + data


_END = object()  # the end of a stream's messages


class _Stream:
    """One HTTP/2 stream of a connection."""

    def __init__(self, sid: int, send_window: int, max_message: int):
        self.id = sid
        self.send_window = send_window
        self.recv_unacked = 0
        self.headers: Optional[List[Tuple[str, str]]] = None
        self.messages: asyncio.Queue = asyncio.Queue()
        self.buf = bytearray()
        self.encoding: Optional[str] = None  # of the messages received
        self.max_message = max_message
        self.remote_closed = False
        self.local_closed = False
        self.reset: Optional[int] = None
        self.finished = False  # a terminal item is in the queue
        self.task: Optional[asyncio.Task] = None
        self.discard = False

    def finish(self, item) -> None:
        if not self.finished:
            self.finished = True
            self.messages.put_nowait(item)

    def take(self, payload: bytes) -> None:
        """Split received DATA into gRPC messages."""
        if self.discard or self.finished:
            return
        self.buf += payload
        while len(self.buf) >= 5:
            n = int.from_bytes(self.buf[1:5], "big")
            if n > self.max_message:
                self.discard = True
                self.buf = bytearray()
                self.finish(RpcError(StatusCode.RESOURCE_EXHAUSTED,
                                     f"received message larger than max ({n} vs. "
                                     f"{self.max_message})"))
                return
            if len(self.buf) < 5 + n:
                return
            flag = self.buf[0]
            msg = bytes(self.buf[5:5 + n])
            del self.buf[:5 + n]
            if flag:
                try:
                    msg = decompress(msg, self.encoding or "", self.max_message)
                except RpcError as ex:
                    self.discard = True
                    self.finish(ex)
                    return
            self.messages.put_nowait(msg)

    async def recv(self) -> Optional[bytes]:
        """The next message; None at the end of the stream."""
        item = await self.messages.get()
        if item is _END:
            self.messages.put_nowait(_END)
            return None
        if isinstance(item, BaseException):
            self.messages.put_nowait(item)
            raise item
        return item


def _header_dict(headers: Sequence[Tuple[str, str]]) -> Dict[str, str]:
    return {k: v for k, v in headers}


class _Connection:
    """One HTTP/2 connection, client or server side."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
                 client: bool, max_message: int = MAX_MESSAGE,
                 on_stream: Optional[Callable[["_Connection", _Stream], None]] = None):
        self.reader = reader
        self.writer = writer
        self.client = client
        self.max_message = max_message
        self.on_stream = on_stream
        self.streams: Dict[int, _Stream] = {}
        self.decoder = HpackDecoder()
        self.peer_initial_window = DEFAULT_WINDOW
        self.peer_max_frame = DEFAULT_MAX_FRAME
        self.send_window = DEFAULT_WINDOW
        self.recv_window = LOCAL_CONN_WINDOW
        self.conn_unacked = 0
        self.next_id = 1
        self.last_peer_id = 0
        self.closed = False
        self.goaway = False
        self._window_event = asyncio.Event()
        self._cont: Optional[Tuple[int, int, bytearray]] = None
        self._reader_task: Optional[asyncio.Task] = None

    # -- writing ---------------------------------------------------------
    def _frame(self, ftype: int, flags: int, sid: int, payload=b"") -> None:
        self.writer.write(len(payload).to_bytes(3, "big") + bytes([ftype, flags])
                          + sid.to_bytes(4, "big"))
        if payload:
            self.writer.write(payload)

    def start(self) -> None:
        """Send the preface (client) and this side's SETTINGS, raise the
        connection window, and start reading."""
        if self.client:
            self.writer.write(PREFACE)
        settings = [(S_INITIAL_WINDOW_SIZE, LOCAL_STREAM_WINDOW),
                    (S_MAX_FRAME_SIZE, LOCAL_MAX_FRAME)]
        if self.client:
            settings.append((S_ENABLE_PUSH, 0))
        self._frame(SETTINGS, 0, 0, b"".join(k.to_bytes(2, "big") + v.to_bytes(4, "big")
                                             for k, v in settings))
        self._frame(WINDOW_UPDATE, 0, 0, (LOCAL_CONN_WINDOW - DEFAULT_WINDOW).to_bytes(4, "big"))
        self._reader_task = asyncio.get_running_loop().create_task(self._read_loop())

    def send_headers(self, sid: int, headers: Sequence[Tuple[str, str]],
                     end_stream: bool = False) -> None:
        """A header block as HEADERS and CONTINUATION frames, written at once."""
        if self.closed:
            raise RpcError(StatusCode.UNAVAILABLE, "connection closed")
        block = encode_headers(headers)
        size = self.peer_max_frame
        chunks = [block[i:i + size] for i in range(0, len(block), size)] or [b""]
        for i, chunk in enumerate(chunks):
            flags = END_HEADERS if i == len(chunks) - 1 else 0
            if i == 0:
                self._frame(HEADERS, flags | (END_STREAM if end_stream else 0), sid, chunk)
            else:
                self._frame(CONTINUATION, flags, sid, chunk)
        if end_stream and sid in self.streams:
            self.streams[sid].local_closed = True
            self._maybe_forget(self.streams[sid])

    def send_rst(self, stream: _Stream, code: int) -> None:
        if not self.closed and stream.reset is None:
            self._frame(RST_STREAM, 0, stream.id, code.to_bytes(4, "big"))
        stream.local_closed = stream.remote_closed = True
        self._maybe_forget(stream)

    async def _wait_window(self) -> None:
        event = self._window_event
        await event.wait()

    def _wake(self) -> None:
        event, self._window_event = self._window_event, asyncio.Event()
        event.set()

    async def send_data(self, stream: _Stream, data: bytes, end_stream: bool = False) -> None:
        """DATA frames of ``data``, each within the peer's frame size and
        the stream's and connection's send windows."""
        view = memoryview(data)
        pos = 0
        while True:
            if self.closed:
                raise RpcError(StatusCode.UNAVAILABLE, "connection closed")
            if stream.reset is not None:
                raise RpcError(StatusCode.CANCELLED, "stream reset by the peer")
            left = len(data) - pos
            n = min(left, self.peer_max_frame, self.send_window, stream.send_window)
            if left and n <= 0:
                await self._wait_window()
                continue
            last = pos + n >= len(data)
            self._frame(DATA, END_STREAM if (last and end_stream) else 0, stream.id,
                        view[pos:pos + n])
            self.send_window -= n
            stream.send_window -= n
            pos += n
            if self.writer.transport.get_write_buffer_size() > (1 << 20):
                await self.writer.drain()
            if last:
                break
        if end_stream:
            stream.local_closed = True
            self._maybe_forget(stream)
        await self.writer.drain()

    # -- streams ---------------------------------------------------------
    def open_stream(self) -> _Stream:
        if self.closed or self.goaway:
            raise RpcError(StatusCode.UNAVAILABLE, "connection closed")
        stream = _Stream(self.next_id, self.peer_initial_window, self.max_message)
        self.next_id += 2
        self.streams[stream.id] = stream
        return stream

    def _maybe_forget(self, stream: _Stream) -> None:
        if stream.local_closed and stream.remote_closed:
            self.streams.pop(stream.id, None)

    # -- reading ---------------------------------------------------------
    async def _read_loop(self) -> None:
        """Read frames until the connection ends (a protocol fault ends it
        with GOAWAY); its open streams then end UNAVAILABLE."""
        try:
            if not self.client:
                if await self.reader.readexactly(len(PREFACE)) != PREFACE:
                    raise ConnectionError_(PROTOCOL_ERROR, "bad connection preface")
            while True:
                head = await self.reader.readexactly(9)
                length = int.from_bytes(head[:3], "big")
                if length > LOCAL_MAX_FRAME:
                    raise ConnectionError_(FRAME_SIZE_ERROR, f"frame of {length} bytes")
                payload = await self.reader.readexactly(length) if length else b""
                self._on_frame(head[3], head[4], int.from_bytes(head[5:9], "big") & 0x7FFFFFFF,
                               payload)
        except ConnectionError_ as ex:
            if not self.closed:
                self._frame(GOAWAY, 0, 0, self.last_peer_id.to_bytes(4, "big")
                            + ex.error_code.to_bytes(4, "big") + str(ex).encode()[:200])
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass  # the peer went away
        finally:
            self._lost()

    def _lost(self) -> None:
        if self.closed:
            return
        self.closed = True
        for stream in list(self.streams.values()):
            stream.finish(RpcError(StatusCode.UNAVAILABLE, "connection lost"))
            if stream.task is not None and not stream.task.done():
                stream.task.cancel()
        self.streams.clear()
        self._wake()
        try:
            self.writer.close()
        except Exception:  # noqa: BLE001 — the transport may be gone already
            pass

    @staticmethod
    def _strip(flags: int, payload: bytes, priority: bool) -> bytes:
        if flags & PADDED:
            if not payload:
                raise ConnectionError_(PROTOCOL_ERROR, "padded frame without padding")
            pad = payload[0]
            payload = payload[1:len(payload) - pad] if pad else payload[1:]
        if priority and flags & PRIORITY_FLAG:
            payload = payload[5:]
        return payload

    def _on_frame(self, ftype: int, flags: int, sid: int, payload: bytes) -> None:
        if self._cont is not None and ftype != CONTINUATION:
            raise ConnectionError_(PROTOCOL_ERROR, "expected CONTINUATION")
        if ftype == DATA:
            self._on_data(flags, sid, payload)
        elif ftype == HEADERS:
            block = self._strip(flags, payload, True)
            if flags & END_HEADERS:
                self._on_headers(sid, flags, block)
            else:
                self._cont = (sid, flags, bytearray(block))
        elif ftype == CONTINUATION:
            if self._cont is None or self._cont[0] != sid:
                raise ConnectionError_(PROTOCOL_ERROR, "unexpected CONTINUATION")
            self._cont[2].extend(payload)
            if len(self._cont[2]) > _MAX_HEADER_BLOCK:
                raise ConnectionError_(PROTOCOL_ERROR, "header block too large")
            if flags & END_HEADERS:
                csid, cflags, block = self._cont
                self._cont = None
                self._on_headers(csid, cflags, bytes(block))
        elif ftype == RST_STREAM:
            stream = self.streams.get(sid)
            if stream is not None:
                stream.reset = int.from_bytes(payload[:4], "big")
                stream.remote_closed = stream.local_closed = True
                code = StatusCode.CANCELLED if stream.reset in (CANCEL, NO_ERROR) \
                    else StatusCode.INTERNAL
                stream.finish(RpcError(code, f"stream reset (HTTP/2 error {stream.reset})"))
                if stream.task is not None and not stream.task.done():
                    stream.task.cancel()
                self.streams.pop(sid, None)
                self._wake()
        elif ftype == SETTINGS:
            if flags & ACK:
                return
            if len(payload) % 6:
                raise ConnectionError_(FRAME_SIZE_ERROR, "bad SETTINGS length")
            for i in range(0, len(payload), 6):
                key = int.from_bytes(payload[i:i + 2], "big")
                value = int.from_bytes(payload[i + 2:i + 6], "big")
                if key == S_INITIAL_WINDOW_SIZE:
                    if value > 0x7FFFFFFF:
                        raise ConnectionError_(FLOW_CONTROL_ERROR, "window too large")
                    delta = value - self.peer_initial_window
                    self.peer_initial_window = value
                    for stream in self.streams.values():
                        stream.send_window += delta
                elif key == S_MAX_FRAME_SIZE:
                    if not DEFAULT_MAX_FRAME <= value <= (1 << 24) - 1:
                        raise ConnectionError_(PROTOCOL_ERROR, "bad SETTINGS_MAX_FRAME_SIZE")
                    self.peer_max_frame = value
            self._frame(SETTINGS, ACK, 0)
            self._wake()
        elif ftype == PING:
            if not flags & ACK:
                self._frame(PING, ACK, 0, payload)
        elif ftype == GOAWAY:
            last = int.from_bytes(payload[:4], "big") & 0x7FFFFFFF
            self.goaway = True
            for stream in list(self.streams.values()):
                if self.client and stream.id > last:
                    stream.finish(RpcError(StatusCode.UNAVAILABLE, "connection going away"))
                    self.streams.pop(stream.id, None)
        elif ftype == WINDOW_UPDATE:
            inc = int.from_bytes(payload[:4], "big") & 0x7FFFFFFF
            if sid == 0:
                self.send_window += inc
            elif sid in self.streams:
                self.streams[sid].send_window += inc
            self._wake()
        elif ftype == PUSH_PROMISE:
            raise ConnectionError_(PROTOCOL_ERROR, "PUSH_PROMISE with push disabled")

    def _on_data(self, flags: int, sid: int, payload: bytes) -> None:
        if sid == 0:
            raise ConnectionError_(PROTOCOL_ERROR, "DATA on stream 0")
        size = len(payload)
        self.recv_window -= size
        if self.recv_window < 0:
            raise ConnectionError_(FLOW_CONTROL_ERROR, "connection window exceeded")
        self.conn_unacked += size
        if self.conn_unacked >= LOCAL_CONN_WINDOW // 4:
            self._frame(WINDOW_UPDATE, 0, 0, self.conn_unacked.to_bytes(4, "big"))
            self.recv_window += self.conn_unacked
            self.conn_unacked = 0
        stream = self.streams.get(sid)
        if stream is None or stream.remote_closed:
            return  # a stream already closed or reset here: dropped
        stream.take(self._strip(flags, payload, False))
        stream.recv_unacked += size
        if flags & END_STREAM:
            self._remote_end(stream)
        elif stream.recv_unacked >= LOCAL_STREAM_WINDOW // 4:
            self._frame(WINDOW_UPDATE, 0, sid, stream.recv_unacked.to_bytes(4, "big"))
            stream.recv_unacked = 0

    def _remote_end(self, stream: _Stream) -> None:
        if self.client:  # a response must end with trailers
            self._client_end(stream, [])
            return
        stream.remote_closed = True
        if stream.buf and not stream.finished:
            stream.finish(RpcError(StatusCode.INTERNAL, "stream ended inside a message"))
        stream.finish(_END)
        self._maybe_forget(stream)

    def _on_headers(self, sid: int, flags: int, block: bytes) -> None:
        headers = self.decoder.decode(block)  # always, to keep the table in step
        stream = self.streams.get(sid)
        if not self.client:
            if stream is None:
                if sid % 2 == 0 or sid <= self.last_peer_id:
                    return  # a closed stream's trailers, or a bad id: dropped
                self.last_peer_id = sid
                if self.goaway:
                    self._frame(RST_STREAM, 0, sid, REFUSED_STREAM.to_bytes(4, "big"))
                    return
                stream = _Stream(sid, self.peer_initial_window, self.max_message)
                stream.headers = headers
                stream.encoding = _header_dict(headers).get("grpc-encoding")
                self.streams[sid] = stream
                if flags & END_STREAM:
                    self._remote_end(stream)
                if self.on_stream is not None:
                    self.on_stream(self, stream)
            elif flags & END_STREAM:
                self._remote_end(stream)
            return
        if stream is None:
            return
        if stream.headers is None:
            stream.headers = headers
            stream.encoding = _header_dict(headers).get("grpc-encoding")
            if flags & END_STREAM:  # Trailers-Only
                self._client_end(stream, headers)
        else:
            self._client_end(stream, headers)

    def _client_end(self, stream: _Stream, trailers: List[Tuple[str, str]]) -> None:
        """The response's end: its status from the trailers."""
        t = _header_dict(trailers)
        stream.remote_closed = True
        if stream.buf and not stream.finished:
            stream.finish(RpcError(StatusCode.INTERNAL, "stream ended inside a message"))
        raw = t.get("grpc-status")
        http = t.get(":status", _header_dict(stream.headers or []).get(":status", "200"))
        if raw is None:
            code = StatusCode.UNKNOWN if http == "200" else _HTTP_TO_GRPC.get(
                http, StatusCode.UNKNOWN)
            stream.finish(RpcError(code, f"no grpc-status (HTTP {http})"))
        else:
            code = int(raw)
            if code == StatusCode.OK:
                stream.finish(_END)
            else:
                stream.finish(RpcError(StatusCode(code) if code in StatusCode._value2member_map_
                                       else StatusCode.UNKNOWN,
                                       percent_decode(t.get("grpc-message", ""))))
        self._maybe_forget(stream)

    async def close(self) -> None:
        if not self.closed:
            try:
                self._frame(GOAWAY, 0, 0, self.last_peer_id.to_bytes(4, "big")
                            + NO_ERROR.to_bytes(4, "big"))
            except Exception:  # noqa: BLE001 — the transport may be gone
                pass
        if self._reader_task is not None and not self._reader_task.done():
            self._reader_task.cancel()
            try:
                await self._reader_task
            except asyncio.CancelledError:
                pass
        self._lost()
        try:
            await self.writer.wait_closed()
        except Exception:  # noqa: BLE001
            pass


_HTTP_TO_GRPC = {"400": StatusCode.INTERNAL, "401": StatusCode.UNAUTHENTICATED,
                 "403": StatusCode.PERMISSION_DENIED, "404": StatusCode.UNIMPLEMENTED,
                 "429": StatusCode.UNAVAILABLE, "502": StatusCode.UNAVAILABLE,
                 "503": StatusCode.UNAVAILABLE, "504": StatusCode.UNAVAILABLE}


# --- server ------------------------------------------------------------------
class AbortError(Exception):
    """Raised by :meth:`ServicerContext.abort`: the call ends with this
    status."""

    def __init__(self, code: StatusCode, details: str):
        super().__init__(details)
        self.code = StatusCode(code)
        self.details = details


class ServicerContext:
    """What a handler learns of its call (``grpc.aio.ServicerContext``'s
    ``invocation_metadata``, ``abort``, ``time_remaining``)."""

    def __init__(self, headers: List[Tuple[str, str]], deadline: Optional[float]):
        self._metadata = tuple((k, v) for k, v in headers
                               if not k.startswith(":") and k not in _NOT_METADATA)
        self._deadline = deadline

    def invocation_metadata(self) -> Tuple[Tuple[str, str], ...]:
        return self._metadata

    async def abort(self, code: StatusCode, details: str = "") -> None:
        raise AbortError(code, details)

    def time_remaining(self) -> Optional[float]:
        if self._deadline is None:
            return None
        return max(self._deadline - asyncio.get_running_loop().time(), 0.0)


UNARY_UNARY, UNARY_STREAM, STREAM_STREAM = "unary_unary", "unary_stream", "stream_stream"


class Server:
    """gRPC server over HTTP/2: ``add_method(path, kind, fn)`` then
    ``await start(host, port)`` (port 0: a free port).  ``fn`` takes the
    request message (bytes; an async iterator of them for
    ``stream_stream``) and a :class:`ServicerContext`, and returns the
    response bytes (``unary_unary``) or yields them.  Responses are
    compressed with ``compression`` when the client accepts it."""

    def __init__(self, compression: Optional[str] = None, max_message: int = MAX_MESSAGE):
        if compression is not None and compression not in _ENCODINGS:
            raise ValueError(f"unknown compression {compression!r}")
        self.compression = compression
        self.max_message = max_message
        self._methods: Dict[str, Tuple[str, Callable]] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        self._connections: set = set()
        self._tasks: set = set()
        self.port = 0

    def add_method(self, path: str, kind: str, fn: Callable) -> None:
        self._methods[path] = (kind, fn)

    async def start(self, host: str, port: int) -> int:
        self._server = await asyncio.start_server(self._serve_connection, host, port,
                                                  limit=1 << 20)
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    async def _serve_connection(self, reader, writer) -> None:
        conn = _Connection(reader, writer, client=False, max_message=self.max_message,
                           on_stream=self._on_stream)
        self._connections.add(conn)
        conn.start()
        try:
            await conn._reader_task
        except asyncio.CancelledError:
            pass
        finally:
            self._connections.discard(conn)

    def _on_stream(self, conn: _Connection, stream: _Stream) -> None:
        task = asyncio.get_running_loop().create_task(self._handle(conn, stream))
        stream.task = task
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    async def _handle(self, conn: _Connection, stream: _Stream) -> None:
        h = _header_dict(stream.headers)
        accepted = h.get("grpc-accept-encoding", "").replace(" ", "").split(",")
        call = _ServerCall(conn, stream,
                           self.compression if self.compression in accepted else None)
        try:
            method = self._methods.get(h.get(":path", ""))
            if h.get(":method") != "POST" or not h.get("content-type", "").startswith(
                    "application/grpc"):
                raise AbortError(StatusCode.UNIMPLEMENTED, "not a gRPC request")
            if method is None:
                raise AbortError(StatusCode.UNIMPLEMENTED, "Method not found!")
            if stream.encoding not in (None, "identity") and stream.encoding not in _ENCODINGS:
                raise AbortError(StatusCode.UNIMPLEMENTED,
                                 f"grpc-encoding {stream.encoding!r} is not supported")
            try:
                timeout = parse_timeout(h.get("grpc-timeout"))
            except ValueError as ex:
                raise AbortError(StatusCode.INTERNAL, str(ex))
            loop = asyncio.get_running_loop()
            deadline = None if timeout is None else loop.time() + timeout
            ctx = ServicerContext(stream.headers, deadline)
            try:
                if timeout is None:
                    await call.run(method, ctx)
                else:
                    async with asyncio.timeout(timeout):
                        await call.run(method, ctx)
            except TimeoutError:
                raise AbortError(StatusCode.DEADLINE_EXCEEDED, "Deadline Exceeded")
            call.end(StatusCode.OK, "")
        except AbortError as ex:
            call.end(ex.code, ex.details)
        except RpcError as ex:
            call.end(ex.code(), ex.details())
        except asyncio.CancelledError:
            if stream.reset is None and not conn.closed:
                call.end(StatusCode.CANCELLED, "server shutting down")
                raise
        except Exception as ex:  # noqa: BLE001 — the call's status, as grpcio reports it
            call.end(StatusCode.UNKNOWN, f"Unexpected {type(ex)}: {ex}")
        try:
            await conn.writer.drain()
        except (ConnectionError, OSError):
            pass

    async def stop(self, grace: Optional[float] = 1.0) -> None:
        """Stop taking connections, let calls in flight finish for ``grace``
        seconds, cancel the rest and close every connection."""
        if self._server is not None:
            self._server.close()
        for conn in list(self._connections):
            conn.goaway = True
            if not conn.closed:
                conn._frame(GOAWAY, 0, 0, conn.last_peer_id.to_bytes(4, "big")
                            + NO_ERROR.to_bytes(4, "big"))
        if self._tasks:
            _, pending = await asyncio.wait(list(self._tasks), timeout=grace)
            for task in pending:
                task.cancel()
            if pending:
                await asyncio.wait(pending, timeout=1.0)
        for conn in list(self._connections):
            await conn.close()
        if self._server is not None:
            await self._server.wait_closed()
            self._server = None


class _ServerCall:
    """The server's side of one call: the request messages in, the
    response headers, messages and trailers out."""

    def __init__(self, conn: _Connection, stream: _Stream, compression: Optional[str]):
        self.conn = conn
        self.stream = stream
        self.compression = compression
        self.headers_sent = False
        self.ended = False

    async def _one_request(self) -> bytes:
        msg = await self.stream.recv()
        if msg is None:
            raise AbortError(StatusCode.INTERNAL, "the request has no message")
        if await self.stream.recv() is not None:
            raise AbortError(StatusCode.INTERNAL, "more than one request message")
        return msg

    async def _requests(self) -> AsyncIterator[bytes]:
        while True:
            msg = await self.stream.recv()
            if msg is None:
                return
            yield msg

    def _send_headers(self) -> None:
        if not self.headers_sent:
            headers = [(":status", "200"), ("content-type", "application/grpc"),
                       ("grpc-accept-encoding", ACCEPT_ENCODING)]
            if self.compression:
                headers.append(("grpc-encoding", self.compression))
            self.conn.send_headers(self.stream.id, headers)
            self.headers_sent = True

    async def send(self, msg: bytes) -> None:
        if len(msg) > self.conn.max_message:
            raise AbortError(StatusCode.RESOURCE_EXHAUSTED,
                             f"response larger than max ({len(msg)} vs. "
                             f"{self.conn.max_message})")
        self._send_headers()
        await self.conn.send_data(self.stream, frame_message(msg, self.compression))

    async def run(self, method: Tuple[str, Callable], ctx: ServicerContext) -> None:
        kind, fn = method
        if kind == UNARY_UNARY:
            await self.send(await fn(await self._one_request(), ctx))
        elif kind == UNARY_STREAM:
            async for out in fn(await self._one_request(), ctx):
                await self.send(out)
        else:
            async for out in fn(self._requests(), ctx):
                await self.send(out)

    def end(self, code: StatusCode, message: str) -> None:
        """Trailers (Trailers-Only when nothing was sent), then RST_STREAM
        (NO_ERROR) when the client is still sending."""
        if self.ended or self.conn.closed or self.stream.reset is not None:
            return
        self.ended = True
        trailers = [("grpc-status", str(int(code)))]
        if message:
            trailers.append(("grpc-message", percent_encode(message)))
        if not self.headers_sent:
            trailers = [(":status", "200"), ("content-type", "application/grpc")] + trailers
        self.conn.send_headers(self.stream.id, trailers, end_stream=True)
        if not self.stream.remote_closed:
            self.stream.discard = True
            self.conn.send_rst(self.stream, NO_ERROR)


# --- client ------------------------------------------------------------------
class Channel:
    """The client side: calls to one ``host:port`` on one HTTP/2
    connection, made on first use and again after it is lost.
    ``compression`` (``"gzip"`` / ``"deflate"``) compresses every request
    message."""

    def __init__(self, address: str, compression: Optional[str] = None,
                 max_message: int = MAX_MESSAGE):
        host, _, port = address.rpartition(":")
        self.host, self.port = host or "127.0.0.1", int(port)
        self.address = address
        if compression is not None and compression not in _ENCODINGS:
            raise ValueError(f"unknown compression {compression!r}")
        self.compression = compression
        self.max_message = max_message
        self._conn: Optional[_Connection] = None
        self._lock: Optional[asyncio.Lock] = None

    async def _connection(self) -> _Connection:
        if self._conn is not None and not self._conn.closed and not self._conn.goaway:
            return self._conn
        if self._lock is None:
            self._lock = asyncio.Lock()
        async with self._lock:
            if self._conn is None or self._conn.closed or self._conn.goaway:
                try:
                    reader, writer = await asyncio.open_connection(self.host, self.port,
                                                                   limit=1 << 20)
                except OSError as ex:
                    raise RpcError(StatusCode.UNAVAILABLE, f"failed to connect to "
                                                           f"{self.address}: {ex}")
                old = self._conn
                self._conn = _Connection(reader, writer, client=True,
                                         max_message=self.max_message)
                self._conn.start()
                if old is not None and not old.streams:
                    await old.close()
            return self._conn

    async def _open(self, path: str, timeout: Optional[float],
                    metadata: Optional[Sequence[Tuple[str, str]]]):
        conn = await self._connection()
        stream = conn.open_stream()
        headers = [(":method", "POST"), (":scheme", "http"), (":path", path),
                   (":authority", self.address), ("content-type", "application/grpc"),
                   ("te", "trailers"), ("user-agent", USER_AGENT),
                   ("grpc-accept-encoding", ACCEPT_ENCODING)]
        if self.compression:
            headers.append(("grpc-encoding", self.compression))
        if timeout is not None:
            headers.append(("grpc-timeout", encode_timeout(timeout)))
        headers += [(k.lower(), v) for k, v in (metadata or ())]
        conn.send_headers(stream.id, headers)
        return conn, stream

    async def _send(self, conn: _Connection, stream: _Stream, msg: bytes,
                    end_stream: bool) -> None:
        if len(msg) > self.max_message:
            raise RpcError(StatusCode.RESOURCE_EXHAUSTED,
                           f"request larger than max ({len(msg)} vs. {self.max_message})")
        await conn.send_data(stream, frame_message(msg, self.compression), end_stream)

    @staticmethod
    def _cancel(conn: _Connection, stream: _Stream) -> None:
        if not stream.finished or not stream.remote_closed:
            conn.send_rst(stream, CANCEL)

    async def unary_unary(self, path: str, request: bytes, timeout: Optional[float] = None,
                          metadata=None) -> bytes:
        """One request, one response."""
        conn = stream = None
        try:
            async with asyncio.timeout(timeout):
                conn, stream = await self._open(path, timeout, metadata)
                await self._send(conn, stream, request, True)
                msg = await stream.recv()
                if msg is None:
                    raise RpcError(StatusCode.INTERNAL, "the response has no message")
                if await stream.recv() is not None:
                    raise RpcError(StatusCode.INTERNAL, "more than one response message")
                return msg
        except TimeoutError:
            if stream is not None:
                self._cancel(conn, stream)
            raise RpcError(StatusCode.DEADLINE_EXCEEDED, "Deadline Exceeded") from None
        except asyncio.CancelledError:
            if stream is not None:
                self._cancel(conn, stream)
            raise
        except RpcError:
            if stream is not None:
                self._cancel(conn, stream)
            raise

    async def _responses(self, conn, stream, deadline, sender=None) -> AsyncIterator[bytes]:
        loop = asyncio.get_running_loop()
        try:
            while True:
                left = None if deadline is None else deadline - loop.time()
                if left is not None and left <= 0:
                    raise TimeoutError
                msg = await asyncio.wait_for(stream.recv(), left)
                if msg is None:
                    if sender is not None:
                        await sender
                    return
                yield msg
        except TimeoutError:
            self._cancel(conn, stream)
            raise RpcError(StatusCode.DEADLINE_EXCEEDED, "Deadline Exceeded") from None
        except BaseException:
            self._cancel(conn, stream)
            raise
        finally:
            if sender is not None and not sender.done():
                sender.cancel()
            if not stream.finished:
                self._cancel(conn, stream)

    async def unary_stream(self, path: str, request: bytes, timeout: Optional[float] = None,
                           metadata=None) -> AsyncIterator[bytes]:
        """One request, the responses as the server sends them."""
        loop = asyncio.get_running_loop()
        deadline = None if timeout is None else loop.time() + timeout
        conn, stream = await self._open(path, timeout, metadata)
        await self._send(conn, stream, request, True)
        async for msg in self._responses(conn, stream, deadline):
            yield msg

    async def stream_stream(self, path: str, requests, timeout: Optional[float] = None,
                            metadata=None) -> AsyncIterator[bytes]:
        """Requests from an (async) iterable sent while the responses come
        back."""
        loop = asyncio.get_running_loop()
        deadline = None if timeout is None else loop.time() + timeout
        conn, stream = await self._open(path, timeout, metadata)

        async def send_all():
            if hasattr(requests, "__aiter__"):
                async for r in requests:
                    await self._send(conn, stream, r, False)
            else:
                for r in requests:
                    await self._send(conn, stream, r, False)
            await conn.send_data(stream, b"", True)

        sender = loop.create_task(send_all())
        async for msg in self._responses(conn, stream, deadline, sender):
            yield msg

    async def close(self) -> None:
        if self._conn is not None:
            await self._conn.close()
            self._conn = None

    async def __aenter__(self) -> "Channel":
        return self

    async def __aexit__(self, *args) -> None:
        await self.close()
