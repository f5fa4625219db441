"""WebSocket (RFC 6455) on ``asyncio``, written on the standard library:
the part of the serving plane that aiohttp's WebSocket is in the JAX
package (the card's machine has no aiohttp), as ``grpc_wire.py`` stands in
for grpcio.

The opening handshake: ``Sec-WebSocket-Accept`` is base64(SHA-1(key +
:data:`GUID`)); versions 13, 8 and 7 are taken, as aiohttp takes them.
Offered extensions (``permessage-deflate``) are declined, which RFC 6455
§9.1 allows: the answer names none, and a frame with a reserved bit set
closes the connection (1002).  Frames: masked from the client, unmasked
from the server (the other way closes with 1002); 7-, 16- and 64-bit
lengths; text and binary messages, continuation frames reassembled; a
message past ``max_msg_size`` (64 MiB, the JAX server's) closes with 1009,
text that is not UTF-8 with 1007.  Control frames: a ping is answered
with a pong and not returned (aiohttp's ``autoping``), a pong is dropped,
and the close handshake echoes the peer's code.  Frame writes of one
socket are serialised by a lock, so that several tasks may send at once.
"""

import asyncio
import base64
import binascii
import enum
import hashlib
import json
import os
import struct
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
#: the largest message either side takes (the JAX server's ``max_msg_size``)
MAX_MESSAGE = 64 * 1024 * 1024
#: how long a closing side waits for the peer's close frame
CLOSE_TIMEOUT_S = 10.0
VERSIONS = ("13", "8", "7")


class Opcode(enum.IntEnum):
    CONTINUATION = 0x0
    TEXT = 0x1
    BINARY = 0x2
    CLOSE = 0x8
    PING = 0x9
    PONG = 0xA


class MsgType(enum.IntEnum):
    """What :meth:`WebSocket.receive` returns (aiohttp's ``WSMsgType`` values)."""
    TEXT = 0x1
    BINARY = 0x2
    CLOSE = 0x8
    CLOSED = 0x101
    ERROR = 0x102


class CloseCode(enum.IntEnum):
    NORMAL = 1000
    GOING_AWAY = 1001
    PROTOCOL_ERROR = 1002
    INVALID_TEXT = 1007
    MESSAGE_TOO_BIG = 1009


class ProtocolError(Exception):
    """A frame the protocol does not allow: the connection closes with ``code``."""

    def __init__(self, code: int, reason: str):
        super().__init__(reason)
        self.code = code
        self.reason = reason


class HandshakeError(Exception):
    """The server did not switch protocols: its status and body."""

    def __init__(self, status: int, message: str):
        super().__init__(f"{status}: {message}")
        self.status = status
        self.message = message


class WSMessage(NamedTuple):
    type: MsgType
    data: Union[str, bytes, int, None]
    extra: Optional[str] = None

    def json(self):
        return json.loads(self.data)


def accept_key(key: str) -> str:
    """The ``Sec-WebSocket-Accept`` answer to a ``Sec-WebSocket-Key``."""
    return base64.b64encode(hashlib.sha1((key + GUID).encode()).digest()).decode()


def mask_bytes(data: bytes, mask: bytes) -> bytes:
    """``data`` XOR the 4-byte ``mask`` repeated (masking and unmasking)."""
    n = len(data)
    if not n:
        return b""
    key = (mask * (n // 4 + 1))[:n]
    return (int.from_bytes(data, "little") ^ int.from_bytes(key, "little")).to_bytes(n, "little")


def encode_frame(opcode: int, payload: bytes, fin: bool = True,
                 mask: Optional[bytes] = None) -> bytes:
    """One frame; ``mask`` (4 bytes) masks it, as a client must."""
    b0 = (0x80 if fin else 0) | int(opcode)
    mbit = 0x80 if mask is not None else 0
    n = len(payload)
    if n < 126:
        head = bytes((b0, mbit | n))
    elif n < 1 << 16:
        head = struct.pack("!BBH", b0, mbit | 126, n)
    else:
        head = struct.pack("!BBQ", b0, mbit | 127, n)
    if mask is None:
        return head + payload
    return head + mask + mask_bytes(payload, mask)


async def read_frame(reader: asyncio.StreamReader, masked: bool,
                     max_size: int = MAX_MESSAGE) -> Tuple[bool, int, bytes]:
    """(fin, opcode, unmasked payload) of the next frame; ``masked`` says
    whether the peer must mask (it is a client)."""
    b0, b1 = await reader.readexactly(2)
    fin, opcode = bool(b0 & 0x80), b0 & 0x0F
    if b0 & 0x70:
        raise ProtocolError(CloseCode.PROTOCOL_ERROR, "reserved bits set (no extension)")
    if opcode not in Opcode.__members__.values():
        raise ProtocolError(CloseCode.PROTOCOL_ERROR, f"unknown opcode {opcode}")
    if bool(b1 & 0x80) != masked:
        raise ProtocolError(CloseCode.PROTOCOL_ERROR,
                            "unmasked client frame" if masked else "masked server frame")
    n = b1 & 0x7F
    if n == 126:
        n = struct.unpack("!H", await reader.readexactly(2))[0]
    elif n == 127:
        n = struct.unpack("!Q", await reader.readexactly(8))[0]
    if opcode >= Opcode.CLOSE and (not fin or n > 125):
        raise ProtocolError(CloseCode.PROTOCOL_ERROR, "fragmented or long control frame")
    if n > max_size:
        raise ProtocolError(CloseCode.MESSAGE_TOO_BIG,
                            f"Message size {n} exceeds limit {max_size}")
    mask = await reader.readexactly(4) if masked else None
    payload = await reader.readexactly(n)
    return fin, opcode, payload if mask is None else mask_bytes(payload, mask)


def server_handshake(headers: Dict[str, str]) -> Dict[str, str]:
    """The 101 answer's headers to an upgrade request (lower-cased header
    names); raises ValueError with aiohttp's 400 text when it is not one."""
    if headers.get("upgrade", "").lower().strip() != "websocket":
        raise ValueError(f"No WebSocket UPGRADE hdr: {headers.get('upgrade')}\n Can "
                         '"Upgrade" only to "WebSocket".')
    if "upgrade" not in headers.get("connection", "").lower():
        raise ValueError(f"No CONNECTION upgrade hdr: {headers.get('connection')}")
    version = headers.get("sec-websocket-version", "")
    if version not in VERSIONS:
        raise ValueError(f"Unsupported version: {version}")
    key = headers.get("sec-websocket-key")
    try:
        if not key or len(base64.b64decode(key)) != 16:
            raise ValueError(f"Handshake error: {key!r}")
    except binascii.Error:
        raise ValueError(f"Handshake error: {key!r}") from None
    # extensions offered in sec-websocket-extensions are declined
    return {"Upgrade": "websocket", "Connection": "upgrade",
            "Sec-WebSocket-Accept": accept_key(key)}


class WebSocket:
    """One side of an open connection (``client``: this side masks)."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
                 client: bool, max_msg_size: int = MAX_MESSAGE):
        self.reader = reader
        self.writer = writer
        self.client = client
        self.max_msg_size = max_msg_size
        self._lock = asyncio.Lock()
        self._close_sent = False
        self._close_received = asyncio.Event()
        self._reading = False
        self._failed = False  # this side closed on a protocol error
        self.close_code: Optional[int] = None

    async def _write(self, opcode: int, payload: bytes) -> None:
        frame = encode_frame(opcode, payload, mask=os.urandom(4) if self.client else None)
        async with self._lock:
            if self._close_sent:
                raise ConnectionResetError("the websocket is closing")
            if opcode == Opcode.CLOSE:
                self._close_sent = True
            self.writer.write(frame)
            await self.writer.drain()

    async def send_str(self, data: str) -> None:
        await self._write(Opcode.TEXT, data.encode("utf-8"))

    async def send_bytes(self, data: bytes) -> None:
        await self._write(Opcode.BINARY, bytes(data))

    async def send_json(self, obj) -> None:
        await self.send_str(json.dumps(obj))

    async def ping(self, payload: bytes = b"") -> None:
        await self._write(Opcode.PING, payload)

    async def _send_close(self, code: int, message: bytes = b"") -> None:
        if self._close_sent:
            return
        try:
            await self._write(Opcode.CLOSE, struct.pack("!H", int(code)) + message[:123])
        except (ConnectionError, OSError):
            self._close_sent = True

    async def receive(self, timeout: Optional[float] = None) -> WSMessage:
        """The next message: TEXT or BINARY, CLOSE (the peer's code) once,
        then CLOSED; ERROR when this side closed on a protocol error."""
        if self._close_received.is_set() or self._failed:
            return WSMessage(MsgType.CLOSED, None)
        self._reading = True
        try:
            return await asyncio.wait_for(self._receive(), timeout)
        finally:
            self._reading = False

    async def _receive(self) -> WSMessage:
        parts: List[bytes] = []
        kind = None
        size = 0
        try:
            while True:
                fin, opcode, payload = await read_frame(self.reader, not self.client,
                                                        self.max_msg_size)
                if opcode == Opcode.PING:
                    await self._write(Opcode.PONG, payload)
                    continue
                if opcode == Opcode.PONG:
                    continue
                if opcode == Opcode.CLOSE:
                    return await self._on_close(payload)
                if opcode == Opcode.CONTINUATION:
                    if kind is None:
                        raise ProtocolError(CloseCode.PROTOCOL_ERROR,
                                            "continuation frame without a message")
                elif kind is not None:
                    raise ProtocolError(CloseCode.PROTOCOL_ERROR,
                                        "new message inside a fragmented one")
                else:
                    kind = opcode
                size += len(payload)
                if size > self.max_msg_size:
                    raise ProtocolError(CloseCode.MESSAGE_TOO_BIG,
                                        f"Message size {size} exceeds limit "
                                        f"{self.max_msg_size}")
                parts.append(payload)
                if not fin:
                    continue
                data = b"".join(parts)
                if kind == Opcode.BINARY:
                    return WSMessage(MsgType.BINARY, data)
                try:
                    return WSMessage(MsgType.TEXT, data.decode("utf-8"))
                except UnicodeDecodeError:
                    raise ProtocolError(CloseCode.INVALID_TEXT, "invalid utf-8 text")
        except ProtocolError as ex:
            self.close_code = ex.code
            self._failed = True
            await self._send_close(ex.code, ex.reason.encode())
            return WSMessage(MsgType.ERROR, ex.code, ex.reason)
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            self._close_received.set()
            return WSMessage(MsgType.CLOSED, None)

    async def _on_close(self, payload: bytes) -> WSMessage:
        code = struct.unpack("!H", payload[:2])[0] if len(payload) >= 2 else CloseCode.NORMAL
        reason = payload[2:].decode("utf-8", "replace")
        if self.close_code is None:
            self.close_code = code
        self._close_received.set()
        await self._send_close(code)  # echo the code (no-op when this side closed first)
        return WSMessage(MsgType.CLOSE, code, reason)

    async def close(self, code: int = CloseCode.NORMAL, message: bytes = b"",
                    timeout: float = CLOSE_TIMEOUT_S) -> None:
        """The close handshake: send the close frame, wait for the peer's
        (read by a task already in :meth:`receive`, else here), then a
        client closes its end of the connection."""
        if self.close_code is None:
            self.close_code = int(code)
        await self._send_close(code, message)
        try:
            if self._reading:
                await asyncio.wait_for(self._close_received.wait(), timeout)
            else:
                loop = asyncio.get_running_loop()
                end = loop.time() + timeout
                while not self._close_received.is_set():
                    msg = await self.receive(max(end - loop.time(), 0.0))
                    if msg.type in (MsgType.CLOSED, MsgType.ERROR):
                        break
        except (TimeoutError, asyncio.TimeoutError):
            pass
        if self.client:
            self.writer.close()
            try:
                await self.writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    def __aiter__(self):
        return self

    async def __anext__(self) -> WSMessage:
        msg = await self.receive()
        if msg.type in (MsgType.CLOSE, MsgType.CLOSED, MsgType.ERROR):
            raise StopAsyncIteration
        return msg


async def _read_response_head(reader: asyncio.StreamReader) -> Tuple[int, Dict[str, str]]:
    line = await reader.readline()
    parts = line.decode("latin-1").split(" ", 2)
    if len(parts) < 2 or not parts[0].startswith("HTTP/1."):
        raise HandshakeError(0, f"not an HTTP answer: {line[:80]!r}")
    headers: Dict[str, str] = {}
    while True:
        hl = await reader.readline()
        if hl in (b"\r\n", b"\n", b""):
            break
        name, _, value = hl.decode("latin-1").partition(":")
        headers[name.strip().lower()] = value.strip()
    return int(parts[1]), headers


async def connect(host: str, port: int, path: str = "/",
                  headers: Optional[Sequence[Tuple[str, str]]] = None,
                  max_msg_size: int = MAX_MESSAGE, timeout: Optional[float] = None) -> WebSocket:
    """Open a client WebSocket to ``ws://host:port/path``; HandshakeError
    with the server's status when it does not switch protocols."""
    async def run() -> WebSocket:
        reader, writer = await asyncio.open_connection(host, port, limit=1 << 16)
        key = base64.b64encode(os.urandom(16)).decode()
        lines = [f"GET {path} HTTP/1.1", f"Host: {host}:{port}", "Upgrade: websocket",
                 "Connection: Upgrade", f"Sec-WebSocket-Key: {key}",
                 "Sec-WebSocket-Version: 13"]
        lines += [f"{k}: {v}" for k, v in (headers or ())]
        writer.write(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1"))
        await writer.drain()
        try:
            status, got = await _read_response_head(reader)
            if status != 101:
                n = int(got.get("content-length", "0") or 0)
                body = await reader.readexactly(n) if n else b""
                raise HandshakeError(status, body.decode("utf-8", "replace"))
            if got.get("upgrade", "").lower() != "websocket" \
                    or "upgrade" not in got.get("connection", "").lower():
                raise HandshakeError(status, "the answer does not upgrade to websocket")
            if got.get("sec-websocket-accept") != accept_key(key):
                raise HandshakeError(status, "wrong Sec-WebSocket-Accept")
            if got.get("sec-websocket-extensions"):
                raise HandshakeError(status, "an extension this side did not offer")
        except BaseException:
            writer.close()
            raise
        return WebSocket(reader, writer, client=True, max_msg_size=max_msg_size)

    return await asyncio.wait_for(run(), timeout)
