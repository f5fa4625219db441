"""HTTP server (port of ``marie_tpu/serve/runtimes/servers/http_server.py``)
on ``asyncio.start_server``: a small HTTP/1.1 server of the standard
library in place of aiohttp, which is not on the card's machine.

It serves the JAX server's routes with the same status codes and JSON
bodies (``json.dumps`` of the same payloads, as aiohttp's
``json_response`` writes them): ``GET /`` ``/health`` ``/dry_run``
``/status`` ``/endpoints`` ``/metrics`` ``/openapi.json``, ``POST /post``
(``{"execEndpoint", "data", "parameters", "targetExecutor"}``) and the
NDJSON ``POST /post_stream``.  With API keys configured, every route but
the probes needs ``Authorization: Bearer <key>`` (401 otherwise).
``/metrics`` adds ``marie_kernel_launches_total{kernel, path}``: the
hand-written kernels' launches in the worker's process, by engine path.

Transport: request bodies by ``Content-Length`` or chunked, 413 above
64 MiB, keep-alive (HTTP/1.1 by default; ``Connection: close`` ends the
connection), chunked responses for the stream.  A request is refused on
its head, before any of its body is read: 401 by the Bearer rule, then
413 by a declared ``Content-Length`` (a chunked body, once it grows past
the limit).  The refusal goes out first; what the client still sends of
the body is then read and dropped a chunk at a time for at most 10 s
(aiohttp's lingering close), and the connection closes.  The gateway's extra
routes and CORS come with the gateway (ROADMAP §1 item 10).
"""

import asyncio
import json
from http import HTTPStatus
from typing import Dict, Optional

from marie_tpu_torch.logging_core import MarieLogger
from marie_tpu_torch.types.docs import DocumentArray
from marie_tpu_torch.types.request import DataRequest

# liveness/readiness probes and the metrics scrape stay open
_OPEN_PATHS = {"/", "/health", "/health/status", "/dry_run", "/metrics", "/ping"}

#: the largest request body (aiohttp's ``client_max_size`` in the JAX server)
MAX_BODY = 64 * 1024 * 1024
_MAX_HEADERS = 100


class _BadRequest(Exception):
    pass


#: how long the body of a refused request is still read and dropped, so
#: that a client that sends its whole body before it reads gets the answer
#: (aiohttp's ``lingering_time``)
_LINGER_S = 10.0


async def _linger(reader: asyncio.StreamReader, n: Optional[int]) -> None:
    """Read and drop up to ``n`` bytes (None: until the client closes)
    for at most _LINGER_S, one chunk at a time."""
    loop = asyncio.get_running_loop()
    end = loop.time() + _LINGER_S
    try:
        while n is None or n > 0:
            chunk = await asyncio.wait_for(
                reader.read(1 << 16 if n is None else min(n, 1 << 16)), end - loop.time())
            if not chunk:
                return
            if n is not None:
                n -= len(chunk)
    except TimeoutError:
        pass


class Response:
    """One HTTP response: status, body bytes and content type."""

    def __init__(self, status: int, body: bytes = b"",
                 content_type: str = "application/json; charset=utf-8",
                 headers: Optional[Dict[str, str]] = None):
        self.status = status
        self.body = body
        self.content_type = content_type
        self.headers = dict(headers or {})


def json_response(payload, status: int = 200) -> Response:
    """aiohttp's ``web.json_response``: ``json.dumps`` of the payload."""
    return Response(status, json.dumps(payload).encode())


def text_response(text: str, status: int = 200,
                  content_type: str = "text/plain; charset=utf-8") -> Response:
    return Response(status, text.encode(), content_type)


def _too_large(size: int) -> Response:
    return text_response(f"Maximum request body size {MAX_BODY} exceeded, actual "
                         f"body size {size}", 413)


def _error(status: int) -> Response:
    """aiohttp's plain-text body of an HTTP error."""
    return text_response(f"{status}: {HTTPStatus(status).phrase}", status)


class _Request:
    """A parsed request: method, path, headers (lower-cased names), body."""

    def __init__(self, method: str, path: str, version: str, headers: Dict[str, str],
                 body: bytes):
        self.method = method
        self.path = path
        self.version = version
        self.headers = headers
        self.body = body

    def json(self):
        return json.loads(self.body.decode("utf-8"))

    @property
    def chunked(self) -> bool:
        return "chunked" in self.headers.get("transfer-encoding", "").lower()

    @property
    def content_length(self) -> int:
        return int(self.headers.get("content-length", "0") or 0)

    @property
    def keep_alive(self) -> bool:
        conn = self.headers.get("connection", "").lower()
        if self.version == "HTTP/1.0":
            return conn == "keep-alive"
        return conn != "close"


class HTTPServer:
    def __init__(self, req_handler, port: Optional[int] = None, host: Optional[str] = None,
                 name: str = "http", **kwargs):
        from marie_tpu_torch.helper import default_bind_host

        self.req_handler = req_handler
        self.port = port or 0  # 0: a free port, known after setup_server
        self.host = host or default_bind_host()
        self.logger = MarieLogger(f"HTTPServer/{name}")
        self._server: Optional[asyncio.AbstractServer] = None
        self._connections: set = set()
        self.name = name
        self._routes = {
            ("GET", "/"): self._index,
            ("GET", "/health"): self._health,
            ("GET", "/dry_run"): self._dry_run,
            ("GET", "/status"): self._status,
            ("GET", "/endpoints"): self._endpoints,
            ("GET", "/metrics"): self._metrics,
            ("GET", "/openapi.json"): self._openapi,
            ("POST", "/post"): self._post,
            ("POST", "/post_stream"): self._post_stream,
        }

    # -- routes ----------------------------------------------------------
    async def dispatch_payload(self, body: dict, nbytes: int = 0) -> Response:
        """``/post``-schema dict (``nbytes`` on the wire) -> handler -> the
        JSON response (500 when the request failed)."""
        endpoint = body.get("execEndpoint", body.get("exec_endpoint", "/"))
        docs_raw = body.get("data", [])
        req = DataRequest.from_docs(
            DocumentArray.from_dict(docs_raw) if docs_raw else DocumentArray(),
            endpoint=endpoint,
            parameters=body.get("parameters") or {},
            target_executor=body.get("targetExecutor", "") or "",
        )
        req.nbytes = nbytes
        resp = await self.req_handler.process_data([req])
        payload = {
            "header": {
                "requestId": resp.request_id,
                "execEndpoint": resp.exec_endpoint,
                "status": _status_dict(resp),
            },
            "parameters": resp.parameters,
            "routes": [{"executor": r.executor, "startTime": r.start_time,
                        "endTime": r.end_time} for r in resp.routes],
            "data": resp.docs.to_dict(),
        }
        out = json_response(payload, status=500 if resp.is_error() else 200)
        recorder = getattr(self.req_handler, "record_response_bytes", None)
        if recorder is not None:
            recorder(len(out.body))
        return out

    async def _index(self, request: _Request) -> Response:
        return json_response({"ok": True})

    async def _health(self, request: _Request) -> Response:
        return json_response({"status": "OK"})

    async def _dry_run(self, request: _Request) -> Response:
        try:
            if hasattr(self.req_handler, "dry_run"):
                await self.req_handler.dry_run()
            return json_response({"code": 0, "description": ""})
        except Exception as ex:  # noqa: BLE001
            return json_response({"code": 1, "description": repr(ex)}, status=500)

    async def _status(self, request: _Request) -> Response:
        return json_response({"jina": self.req_handler.info(), "envs": {}})

    async def _endpoints(self, request: _Request) -> Response:
        eps = self.req_handler.endpoints()
        if asyncio.iscoroutine(eps):
            eps = await eps
        return json_response(eps)

    async def _metrics(self, request: _Request) -> Response:
        """The registry's metrics, then the kernels' launches by path."""
        from marie_tpu_torch.metrics.prometheus import render_launches, render_prometheus
        from marie_tpu_torch.ops.kernels._build import launch_counts

        return text_response(render_prometheus() + render_launches(launch_counts()))

    async def _openapi(self, request: _Request) -> Response:
        return json_response(await self._openapi_spec())

    async def _post(self, request: _Request) -> Response:
        try:
            body = request.json()
        except json.JSONDecodeError:
            return json_response({"error": "invalid JSON body"}, status=400)
        return await self.dispatch_payload(body, len(request.body))

    async def _post_stream(self, request: _Request, writer: asyncio.StreamWriter,
                           keep_alive: bool) -> Optional[Response]:
        """NDJSON streaming of one-doc-in/N-docs-out requests: each
        document goes out as its own chunk the moment the (generator)
        endpoint yields it; an error is the stream's last line."""
        handler_stream = getattr(self.req_handler, "process_single_doc_stream", None)
        if handler_stream is None:
            return json_response({"error": "streaming unsupported by this runtime"},
                                 status=501)
        try:
            body = request.json()
        except json.JSONDecodeError:
            return json_response({"error": "invalid JSON body"}, status=400)
        endpoint = body.get("execEndpoint", body.get("exec_endpoint", "/"))
        docs_raw = body.get("data", [])
        req = DataRequest.from_docs(
            DocumentArray.from_dict(docs_raw) if docs_raw else DocumentArray(),
            endpoint=endpoint, parameters=body.get("parameters") or {})
        writer.write(self._head(200, {"Content-Type": "application/x-ndjson",
                                      "Transfer-Encoding": "chunked"}, keep_alive))

        async def chunk(data: bytes) -> None:
            writer.write(b"%x\r\n%s\r\n" % (len(data), data))
            await writer.drain()

        try:
            async for doc in handler_stream(req):
                await chunk((json.dumps(doc.to_dict()) + "\n").encode())
        except Exception as ex:  # noqa: BLE001 — streamed as the last line
            await chunk((json.dumps({"error": repr(ex)}) + "\n").encode())
        writer.write(b"0\r\n\r\n")
        await writer.drain()
        return None

    async def _openapi_spec(self) -> dict:
        """OpenAPI 3 document of the REST surface, with the live exec
        endpoints."""
        eps = self.req_handler.endpoints()
        if asyncio.iscoroutine(eps):
            eps = await eps
        exec_endpoints = sorted(eps.get("endpoints", []))
        doc_schema = {
            "type": "object",
            "properties": {
                "id": {"type": "string"},
                "text": {"type": "string"},
                "uri": {"type": "string"},
                "tags": {"type": "object"},
                "tensor": {"description": "nested list / base64 ndarray"},
            },
        }
        data_request = {
            "type": "object",
            "properties": {
                "execEndpoint": {"type": "string", "enum": exec_endpoints or None},
                "data": {"type": "array", "items": doc_schema},
                "parameters": {"type": "object"},
                "targetExecutor": {"type": "string",
                                   "description": "regex over executor names"},
            },
            "required": ["execEndpoint"],
        }
        if not exec_endpoints:
            data_request["properties"]["execEndpoint"].pop("enum")
        response = {
            "type": "object",
            "properties": {
                "header": {"type": "object"},
                "parameters": {"type": "object"},
                "routes": {"type": "array"},
                "data": {"type": "array", "items": doc_schema},
            },
        }

        def json_of(schema):
            return {"content": {"application/json": {"schema": schema}}}

        def probe(summary, description):
            return {"get": {"summary": summary,
                            "responses": {"200": {"description": description}}}}

        return {
            "openapi": "3.0.3",
            "info": {"title": f"marie-tpu {self.name}", "version": "1"},
            "paths": {
                "/post": {"post": {
                    "summary": "process documents through the flow",
                    "requestBody": json_of(data_request),
                    "responses": {"200": {"description": "ok", **json_of(response)}}}},
                "/post_stream": {"post": {
                    "summary": "NDJSON document streaming",
                    "requestBody": json_of(data_request),
                    "responses": {"200": {"description": "ndjson lines"}}}},
                "/dry_run": probe("flow readiness probe", "ready"),
                "/status": probe("runtime info", "info"),
                "/endpoints": probe("exec endpoint discovery", "endpoints"),
                "/metrics": probe("prometheus exposition", "text"),
                "/health": probe("liveness", "ok"),
            },
        }

    # -- transport -------------------------------------------------------
    @staticmethod
    async def _read_head(reader: asyncio.StreamReader) -> Optional[_Request]:
        """The request line and headers of the connection's next request
        (None at its end); raises _BadRequest on a malformed one."""
        line = await reader.readline()
        if not line:
            return None
        parts = line.decode("latin-1").rstrip("\r\n").split(" ")
        if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
            raise _BadRequest(line[:80])
        method, target, version = parts
        headers: Dict[str, str] = {}
        for _ in range(_MAX_HEADERS + 1):
            hl = await reader.readline()
            if hl in (b"\r\n", b"\n", b""):
                break
            name, sep, value = hl.decode("latin-1").partition(":")
            if not sep:
                raise _BadRequest(hl[:80])
            headers[name.strip().lower()] = value.strip()
        else:
            raise _BadRequest("too many headers")
        return _Request(method.upper(), target.split("?", 1)[0], version, headers, b"")

    @staticmethod
    async def _read_body(reader: asyncio.StreamReader, request: _Request) -> Optional[int]:
        """Read the body into ``request.body``: None, or the size reached
        when a chunked body grows past MAX_BODY (read no further)."""
        if not request.chunked:
            if request.content_length:
                request.body = await reader.readexactly(request.content_length)
            return None
        body = bytearray()
        while True:
            size = int((await reader.readline()).split(b";")[0].strip() or b"0", 16)
            if size == 0:
                while (await reader.readline()) not in (b"\r\n", b"\n", b""):
                    pass  # trailers
                break
            if len(body) + size > MAX_BODY:
                return len(body) + size
            body += await reader.readexactly(size)
            await reader.readexactly(2)
        request.body = bytes(body)
        return None

    @staticmethod
    def _refusal(request: _Request) -> Optional[Response]:
        """The answer to a request refused on its head: 401 without a valid
        Bearer key on a route that is not a probe (when keys are set), then
        413 for a declared body over MAX_BODY."""
        from marie_tpu_torch.auth import auth_enabled, validate_bearer

        if (auth_enabled() and request.path not in _OPEN_PATHS
                and not validate_bearer(request.headers.get("authorization"))):
            return json_response({"error": "missing or invalid API key"}, status=401)
        if not request.chunked and request.content_length > MAX_BODY:
            return _too_large(request.content_length)
        return None

    def _head(self, status: int, headers: Dict[str, str], keep_alive: bool) -> bytes:
        lines = [f"HTTP/1.1 {status} {HTTPStatus(status).phrase}"]
        headers = {**headers, "Connection": "keep-alive" if keep_alive else "close"}
        lines += [f"{k}: {v}" for k, v in headers.items()]
        return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")

    async def _respond(self, request: _Request, writer: asyncio.StreamWriter,
                       keep_alive: bool) -> bool:
        """Answer one request; False when the connection must close."""
        # HEAD is served by the GET route, without the body
        route = ("GET" if request.method == "HEAD" else request.method, request.path)
        allowed = sorted(m for m, p in self._routes if p == request.path)
        try:
            if route == ("POST", "/post_stream"):
                # streams its chunks itself, or answers like a route
                resp = await self._post_stream(request, writer, keep_alive)
                if resp is None:
                    return keep_alive
            elif route in self._routes:
                resp = await self._routes[route](request)
            else:
                resp = _error(405) if allowed else _error(404)
                if allowed:
                    resp.headers["Allow"] = ",".join(allowed)
        except (ConnectionError, asyncio.CancelledError):
            raise
        except Exception as ex:  # noqa: BLE001 — a 500, as aiohttp answers
            self.logger.error(f"{request.method} {request.path} failed: {ex!r}")
            resp = text_response("500 Internal Server Error\n\n"
                                 "Server got itself in trouble", 500)
        await self._send(writer, resp, request.method, keep_alive)
        return keep_alive

    async def _send(self, writer: asyncio.StreamWriter, resp: Response, method: str,
                    keep_alive: bool) -> None:
        headers = {"Content-Type": resp.content_type, "Content-Length": str(len(resp.body)),
                   **resp.headers}
        writer.write(self._head(resp.status, headers, keep_alive))
        if method != "HEAD":
            writer.write(resp.body)
        await writer.drain()

    async def _serve_connection(self, reader: asyncio.StreamReader,
                                writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._connections.add(task)
        try:
            while True:
                try:
                    request = await self._read_head(reader)
                    if request is None:
                        break
                    refusal = self._refusal(request)
                    if refusal is None:
                        over = await self._read_body(reader, request)
                        refusal = None if over is None else _too_large(over)
                except (_BadRequest, ValueError, UnicodeDecodeError):
                    writer.write(self._head(400, {"Content-Type": "text/plain; charset=utf-8",
                                                  "Content-Length": "0"}, False))
                    await writer.drain()
                    break
                if refusal is not None:
                    unread = request.chunked or request.content_length > 0
                    await self._send(writer, refusal, request.method,
                                     request.keep_alive and not unread)
                    if not unread and request.keep_alive:
                        continue
                    await _linger(reader, None if request.chunked else request.content_length)
                    break
                if not await self._respond(request, writer, request.keep_alive):
                    break
        except (ConnectionError, asyncio.IncompleteReadError, asyncio.CancelledError):
            pass
        finally:
            self._connections.discard(task)
            writer.close()

    async def setup_server(self) -> None:
        self._server = await asyncio.start_server(
            self._serve_connection, self.host, self.port, limit=1 << 16)
        self.port = self._server.sockets[0].getsockname()[1]
        self.logger.debug(f"HTTP server serving on {self.host}:{self.port}")

    async def run_server(self) -> None:
        while True:  # the server runs inside the loop; park
            await asyncio.sleep(3600)

    async def shutdown(self) -> None:
        # the runtime owns the handler's lifecycle; the server stops the transport
        if self._server is not None:
            self._server.close()
            for task in list(self._connections):
                task.cancel()
            await self._server.wait_closed()
            self._server = None

    @property
    def address(self) -> str:
        host = "127.0.0.1" if self.host == "0.0.0.0" else self.host
        return f"http://{host}:{self.port}"


def _status_dict(resp: DataRequest) -> dict:
    st = resp.status
    out = {"code": int(st.code), "description": st.description}
    if st.exception.name:
        out["exception"] = {"name": st.exception.name, "args": list(st.exception.args),
                            "stacks": list(st.exception.stacks),
                            "executor": st.exception.executor}
    return out
