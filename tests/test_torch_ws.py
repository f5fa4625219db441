"""The port's WebSocket (``serve/networking/ws_wire.py``, the WebSocket
server and client) against RFC 6455 and against the JAX package's
aiohttp server and client.

The codec is held to the RFC's own examples (§1.3's accept key, §5.7's
frames) and to a derandomized hypothesis round trip.  One loop thread
serves the echo executor of ``tests/test_torch_serve.py`` and a token
streamer from the port's ``WebSocketServer`` and from the JAX one, each
over its own package's worker handler; each package's client drives
both servers: equal answers, streamed documents, the error messages,
401 and answers in completion order.  Answers are compared with request
ids masked."""

import asyncio
import json
import time

import aiohttp
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from marie_tpu.clients.websocket_client import WebSocketClient as JWebSocketClient
from marie_tpu.excepts import BadServer as JBadServer
from marie_tpu.serve.executors import BaseExecutor as JBaseExecutor
from marie_tpu.serve.executors import decorators as jdec
from marie_tpu.serve.runtimes.servers.websocket_server import WebSocketServer as JWebSocketServer
from marie_tpu.serve.runtimes.worker.request_handling import (
    WorkerRequestHandler as JWorkerRequestHandler)
from marie_tpu.types.docs import Document as JDocument
from marie_tpu_torch.clients import Client, WebSocketClient
from marie_tpu_torch.excepts import BadServer
from marie_tpu_torch.serve.executors import BaseExecutor
from marie_tpu_torch.serve.executors import decorators as tdec
from marie_tpu_torch.serve.networking import ws_wire
from marie_tpu_torch.serve.networking.ws_wire import MsgType, Opcode
from marie_tpu_torch.serve.runtimes.servers.websocket_server import WebSocketServer
from marie_tpu_torch.serve.runtimes.worker.request_handling import WorkerRequestHandler
from marie_tpu_torch.types.docs import Document
from tests.test_torch_serve import SEED, JEcho, TEcho, _Loop

MASK = bytes((0x37, 0xFA, 0x21, 0x3D))  # RFC 6455 §5.7's masking key


def _tokens_class(base, dec):
    """``tests/integration/executors.py::TokenStreamExecutor`` on one
    package's base class: one document a token, 50 ms apart."""

    class Tokens(base):
        @dec.requests(on="/stream")
        async def stream_tokens(self, docs, **kwargs):
            for i, tok in enumerate((docs[0].text or "").split()):
                await asyncio.sleep(0.05)
                yield type(docs[0])(id=f"tok{i}", text=tok)

    return Tokens


JTokens = _tokens_class(JBaseExecutor, jdec)
TTokens = _tokens_class(BaseExecutor, tdec)


@pytest.fixture(scope="module")
def servers():
    s = _Loop()
    s.port = s.serve(WebSocketServer(WorkerRequestHandler(uses=TEcho, name="echo"), name="t"))
    s.jax = s.serve(JWebSocketServer(JWorkerRequestHandler(uses=JEcho, name="echo"), name="t"))
    s.port_tokens = s.serve(WebSocketServer(WorkerRequestHandler(uses=TTokens, name="tok"),
                                            name="tok"))
    s.jax_tokens = s.serve(JWebSocketServer(JWorkerRequestHandler(uses=JTokens, name="tok"),
                                            name="tok"))
    yield s
    s.close()


# --- the codec --------------------------------------------------------------
class _Sink:
    """A StreamWriter that keeps what is written."""

    def __init__(self):
        self.data = bytearray()
        self.closed = False

    def write(self, b):
        self.data += b

    async def drain(self):
        pass

    def close(self):
        self.closed = True

    async def wait_closed(self):
        pass


def _reader(data: bytes) -> asyncio.StreamReader:
    r = asyncio.StreamReader()
    r.feed_data(data)
    r.feed_eof()
    return r


def test_codec_against_rfc6455_examples():
    """§1.3's accept key; §5.7's frames encoded to the byte and read back:
    unmasked and masked "Hello", a fragmented text, ping and pong, 256-byte
    and 64 KiB binary lengths; a ping is answered with its pong."""
    assert ws_wire.accept_key("dGhlIHNhbXBsZSBub25jZQ==") == "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="
    hello = b"Hello"
    frames = {
        "text": (ws_wire.encode_frame(Opcode.TEXT, hello), "810548656c6c6f"),
        "masked": (ws_wire.encode_frame(Opcode.TEXT, hello, mask=MASK),
                   "818537fa213d7f9f4d5158"),
        "frag1": (ws_wire.encode_frame(Opcode.TEXT, b"Hel", fin=False), "010348656c"),
        "frag2": (ws_wire.encode_frame(Opcode.CONTINUATION, b"lo"), "80026c6f"),
        "ping": (ws_wire.encode_frame(Opcode.PING, hello), "890548656c6c6f"),
        "pong": (ws_wire.encode_frame(Opcode.PONG, hello, mask=MASK), "8a8537fa213d7f9f4d5158"),
    }
    for name, (got, want) in frames.items():
        assert got.hex() == want, name
    b256, b64k = bytes(range(256)), bytes(65536)
    assert ws_wire.encode_frame(Opcode.BINARY, b256)[:4].hex() == "827e0100"
    assert ws_wire.encode_frame(Opcode.BINARY, b64k)[:10].hex() == "827f0000000000010000"

    async def run():
        # a client reads the server's unmasked frames, a server the masked pong
        got = [await ws_wire.read_frame(_reader(frames["masked"][0]), masked=True),
               await ws_wire.read_frame(_reader(frames["pong"][0]), masked=True)]
        stream = b"".join(f[0] for f in (frames["frag1"], frames["ping"], frames["frag2"])) \
            + ws_wire.encode_frame(Opcode.BINARY, b256) \
            + ws_wire.encode_frame(Opcode.BINARY, b64k) + frames["text"][0] \
            + ws_wire.encode_frame(Opcode.CLOSE, b"\x03\xe8bye")
        sink = _Sink()
        ws = ws_wire.WebSocket(_reader(stream), sink, client=True)
        msgs = [await ws.receive() for _ in range(6)]
        return got, msgs, bytes(sink.data)

    got, msgs, written = asyncio.run(run())
    assert got == [(True, Opcode.TEXT, hello), (True, Opcode.PONG, hello)]
    assert [(m.type, m.data if m.type != MsgType.BINARY else len(m.data)) for m in msgs] == [
        (MsgType.TEXT, "Hello"), (MsgType.BINARY, 256), (MsgType.BINARY, 65536),
        (MsgType.TEXT, "Hello"), (MsgType.CLOSE, 1000), (MsgType.CLOSED, None)]
    assert msgs[1].data == b256 and msgs[4].extra == "bye"
    # the ping's pong went out (masked, as a client's), then the close echo
    fin_op, mlen = written[0], written[1]
    assert (fin_op, mlen) == (0x8A, 0x85)
    assert ws_wire.mask_bytes(written[6:11], written[2:6]) == hello
    assert written[11] == 0x88 and ws_wire.mask_bytes(written[17:19], written[13:17]) == b"\x03\xe8"


@pytest.mark.parametrize("frame,code", [
    (ws_wire.encode_frame(Opcode.TEXT, b"x"), 1002),  # a client must mask
    (bytes((0xC1, 0x81)) + MASK + b"x", 1002),  # RSV1: no extension was agreed
    (ws_wire.encode_frame(Opcode.CONTINUATION, b"x", mask=MASK), 1002),
    (ws_wire.encode_frame(Opcode.PING, b"x", fin=False, mask=MASK), 1002),
    (ws_wire.encode_frame(Opcode.TEXT, b"\xff\xfe", mask=MASK), 1007),
    (ws_wire.encode_frame(Opcode.BINARY, bytes(300), mask=MASK), 1009),
    (ws_wire.encode_frame(Opcode.TEXT, bytes(200), fin=False, mask=MASK)
     + ws_wire.encode_frame(Opcode.CONTINUATION, bytes(200), mask=MASK), 1009)])
def test_server_side_refuses_bad_frames_with_their_close_code(frame, code):
    """A server closes on what RFC 6455 forbids, with its code; a message
    past the limit (here 256 bytes) closes with 1009, even in pieces."""
    async def run():
        sink = _Sink()
        ws = ws_wire.WebSocket(_reader(frame), sink, client=False, max_msg_size=256)
        return await ws.receive(), await ws.receive(), bytes(sink.data)

    msg, after, written = asyncio.run(run())
    assert (msg.type, msg.data) == (MsgType.ERROR, code)
    assert after.type == MsgType.CLOSED
    assert written[:2] == bytes((0x88, len(written) - 2)) and written[2:4] == code.to_bytes(2, "big")


@settings(derandomize=True, max_examples=60, deadline=None)
@given(st.lists(st.tuples(st.booleans(), st.binary(max_size=70000) | st.binary(max_size=130),
                          st.integers(1, 4)), min_size=1, max_size=4))
def test_messages_round_trip_through_frames(messages):
    """Random text and binary messages, each cut into 1-4 frames, masked by
    a client and read back by a server as the same messages."""
    stream = bytearray()
    want = []
    for is_text, payload, pieces in messages:
        if is_text:
            payload = payload.decode("latin-1").encode("utf-8")
        cuts = sorted({len(payload) * k // pieces for k in range(1, pieces)})
        parts = [payload[a:b] for a, b in zip([0] + cuts, cuts + [len(payload)])]
        for k, part in enumerate(parts):
            op = (Opcode.TEXT if is_text else Opcode.BINARY) if k == 0 else Opcode.CONTINUATION
            stream += ws_wire.encode_frame(op, part, fin=k == len(parts) - 1,
                                           mask=bytes(np.random.default_rng(k).bytes(4)))
        want.append((MsgType.TEXT, payload.decode("utf-8")) if is_text
                    else (MsgType.BINARY, payload))

    async def run():
        ws = ws_wire.WebSocket(_reader(bytes(stream)), _Sink(), client=False)
        return [tuple((await ws.receive())[:2]) for _ in want]

    assert asyncio.run(run()) == want


# --- the servers and clients, both packages --------------------------------
CLIENTS = {"port": (WebSocketClient, Document, BadServer),
           "jax": (JWebSocketClient, JDocument, JBadServer)}


def _docs(cls, n=4):
    rng = np.random.default_rng(SEED)
    return [cls(id=f"d{i}", text=f"t{i}", tags={"k": i},
                tensor=rng.integers(0, 255, (2, 3), dtype=np.uint8)) for i in range(n)]


def _masked(body):
    body = json.loads(json.dumps(body))
    body["header"]["requestId"] = "<id>"
    return body


@pytest.mark.parametrize("client", ["port", "jax"])
def test_clients_get_equal_answers_from_both_servers(servers, client):
    """Each client against each server: the answers' JSON (ids masked),
    docs in request order over one socket, a streamed generator endpoint,
    and a failed request's error."""
    cls, doc, bad = CLIENTS[client]

    async def run(port):
        c = cls(port=port)
        out = [[_masked(b) for b in await c.apost(
            "/echo", _docs(doc), request_size=2, parameters={"suffix": "s"},
            return_responses=True)]]
        got = await c.apost("/stats", _docs(doc), request_size=3, parameters={"scale": 2})
        out.append([json.loads(d.to_json()) for d in got])
        out.append([d.text async for d in c.astream_doc("/stream", doc(id="a", text="q"))])
        try:
            await c.apost("/boom", _docs(doc, 1))
            out.append("answered")
        except bad as ex:
            out.append(str(ex))
        failed = []
        got = await c.apost("/boom", _docs(doc, 2), request_size=1, on_error=failed.append)
        out.append((len(got), [_masked(b)["header"] for b in failed]))
        return out

    port = asyncio.run(run(servers.port.port))
    jax = asyncio.run(run(servers.jax.port))
    assert port == jax
    assert [d["text"] for b in port[0] for d in b["data"]] == [f"echo:t{i}:s" for i in range(4)]
    assert port[2] == ["q/0", "q/1"] and "intentional failure" in port[3]


def test_raw_messages_completion_order_and_bad_json(servers):
    """On one socket: a bad message gets ``{"error": "invalid JSON"}`` and
    the socket stays open; a slow request sent first answers after a fast
    one sent second (each request on its own task); the requestIds come
    back; a binary message is ignored.  Both servers, by aiohttp's client
    and by the port's."""
    async def aio(port):
        out = []
        async with aiohttp.ClientSession() as s:
            async with s.ws_connect(f"http://127.0.0.1:{port}/ws") as ws:
                await ws.send_str("not-json")
                out.append(await ws.receive_json())
                await ws.send_bytes(b"\x00")
                for rid, ep in (("slow", "/slow"), ("fast", "/echo")):
                    await ws.send_json({"header": {"requestId": rid}, "execEndpoint": ep,
                                        "data": [{"id": rid, "text": rid}]})
                for _ in range(2):
                    body = await ws.receive_json(timeout=30)
                    out.append((body["header"]["requestId"], body["data"][0]["text"]))
        return out

    async def port_raw(port):
        out = []
        ws = await ws_wire.connect("127.0.0.1", port, "/")
        await ws.send_str("not-json")
        out.append((await ws.receive(30)).json())
        await ws.send_bytes(b"\x00")
        for rid, ep in (("slow", "/slow"), ("fast", "/echo")):
            await ws.send_json({"header": {"requestId": rid}, "execEndpoint": ep,
                                "data": [{"id": rid, "text": rid}]})
        for _ in range(2):
            body = (await ws.receive(30)).json()
            out.append((body["header"]["requestId"], body["data"][0]["text"]))
        await ws.ping(b"p")
        await ws.close()
        out.append(ws.close_code)
        return out

    want = [{"error": "invalid JSON"}, ("fast", "echo:fast:"), ("slow", "slow")]
    for port in (servers.port.port, servers.jax.port):
        assert asyncio.run(aio(port)) == want
        assert asyncio.run(port_raw(port)) == want + [1000]


def test_bearer_key_and_handshake_refusals(servers, monkeypatch):
    """With API keys set the upgrade needs the Bearer key: 401 from both
    servers to both clients without it, the answer with it; a GET without
    the upgrade headers gets aiohttp's 400 text; another path 404."""
    import http.client

    from marie_tpu.auth import APIKeyManager as JKeys
    from marie_tpu_torch.auth import APIKeyManager as TKeys

    monkeypatch.setattr(JKeys, "_keys", {})
    monkeypatch.setattr(TKeys, "_keys", {})
    TKeys.from_config([{"name": "n", "api_key": "mas_k"}])
    JKeys.from_config([{"name": "n", "api_key": "mas_k"}])

    async def run(port):
        out = []
        for name, (cls, doc, _) in CLIENTS.items():
            try:
                await cls(port=port).apost("/echo", [doc(id="a", text="x")])
                out.append("answered")
            except (ws_wire.HandshakeError, aiohttp.WSServerHandshakeError) as ex:
                out.append(ex.status)
            got = await cls(port=port, api_key="mas_k").apost("/echo", [doc(id="a", text="x")])
            out.append(got[0].text)
        return out

    def plain(port, path, headers):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("GET", path, headers={"Authorization": "Bearer mas_k", **headers})
        r = conn.getresponse()
        out = (r.status, r.read().decode())
        conn.close()
        return out

    for port in (servers.port.port, servers.jax.port):
        assert asyncio.run(run(port)) == [401, "echo:x:", 401, "echo:x:"]
    for path, headers in (("/", {}), ("/ws", {"Upgrade": "websocket"}),
                          ("/", {"Upgrade": "websocket", "Connection": "Upgrade",
                                 "Sec-WebSocket-Version": "12"}),
                          ("/", {"Upgrade": "websocket", "Connection": "Upgrade",
                                 "Sec-WebSocket-Version": "13", "Sec-WebSocket-Key": "abc"})):
        port, jax = plain(servers.port.port, path, headers), plain(servers.jax.port, path, headers)
        assert port == jax and port[0] == 400, (path, headers)
    assert plain(servers.port.port, "/other", {})[0] == plain(servers.jax.port, "/other", {})[0] \
        == 404


# --- the JAX tests' cases, on both servers ---------------------------------
def test_elasticity_websocket_roundtrip_case(servers):
    """``tests/integration/test_elasticity.py::test_websocket_server_roundtrip``
    on both servers: an echo answer, then a bad payload's error, socket open."""
    async def run(address):
        async with aiohttp.ClientSession() as session:
            async with session.ws_connect(address) as ws:
                await ws.send_json({"execEndpoint": "/echo",
                                    "data": [JDocument(text="ws").to_dict()]})
                msg = await asyncio.wait_for(ws.receive_json(), 10)
                await ws.send_str("not-json")
                err = await asyncio.wait_for(ws.receive_json(), 10)
                return msg["header"]["status"]["code"], [d["text"] for d in msg["data"]], err

    port = asyncio.run(run(servers.port.address))
    assert port == asyncio.run(run(servers.jax.address)) == (0, ["echo:ws:"],
                                                             {"error": "invalid JSON"})


def test_stream_doc_generator_cases(servers):
    """``tests/integration/test_stream_doc_generator.py`` ``test_websocket_doc_streaming``
    (a ``{"stream": true}`` message gives one message a document, as each
    is produced, then ``done``) and ``test_ws_client_astream_doc_surface``,
    on both servers, with each package's client."""
    async def arrivals(port):
        out = []
        async with aiohttp.ClientSession() as s:
            async with s.ws_connect(f"http://127.0.0.1:{port}/") as ws:
                await ws.send_json({"execEndpoint": "/stream", "stream": True,
                                    "data": [{"id": "d0", "text": "p q r"}],
                                    "header": {"requestId": "rq1"}})
                async for msg in ws:
                    body = json.loads(msg.data)
                    if body.get("done"):
                        out.append(("done", body["header"]["requestId"]))
                        break
                    out.append((time.perf_counter(), body["doc"]["text"]))
        return out

    async def surface(port):
        texts = []
        for name, (cls, doc, _) in CLIENTS.items():
            texts.append([d.text async for d in cls(port=port).astream_doc(
                "/stream", doc(id="d0", text="u v w"))])
        return texts

    for port in (servers.port_tokens.port, servers.jax_tokens.port):
        got = asyncio.run(arrivals(port))
        assert [t for _, t in got[:-1]] == ["p", "q", "r"] and got[-1] == ("done", "rq1")
        assert got[-2][0] - got[0][0] > 0.05, "the documents came in one burst"
        assert asyncio.run(surface(port)) == [["u", "v", "w"]] * 2


def test_client_factory_and_server_close(servers):
    """``Client(protocol="websocket")`` is the WebSocket client; a server
    closed with a socket open sends 1001 and its port is free after."""
    import socket

    from tests.test_torch_serve import _Loop

    assert isinstance(Client(port=1, protocol="websocket"), WebSocketClient)
    loop = _Loop()
    server = loop.serve(WebSocketServer(WorkerRequestHandler(uses=TEcho, name="echo")))

    async def hold():
        ws = await ws_wire.connect("127.0.0.1", server.port)
        await ws.send_json({"execEndpoint": "/echo", "data": [{"text": "a"}]})
        first = (await ws.receive(30)).json()["data"][0]["text"]
        closing = asyncio.wrap_future(asyncio.run_coroutine_threadsafe(server.shutdown(),
                                                                       loop.loop))
        msg = await ws.receive(30)
        await ws.close()
        await closing
        return first, msg.type, msg.data, msg.extra

    assert asyncio.run(hold()) == ("echo:a:", MsgType.CLOSE, 1001, "Server shutdown")
    loop.servers.clear()
    loop.close()
    with socket.socket() as s:
        s.bind(("127.0.0.1", server.port))
