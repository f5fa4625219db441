"""HTTP client (port of ``marie_tpu/clients/http_client.py``) on
``http.client`` in place of aiohttp.

``HTTPClient(port=...).post(on, inputs, parameters=...)`` posts documents
to a server's ``/post`` and returns the response's documents, with the
JAX client's options: ``request_size`` chunking, retries with exponential
backoff on connection errors and 502/503/504, ``on_done`` / ``on_error`` /
``on_always`` callbacks with the parsed body, ``continue_on_error`` and
``return_responses``.  A client is used from one thread at a time; it
keeps one keep-alive connection.  :attr:`last_timings` holds the seconds
the last ``post`` spent encoding JSON, waiting for the server and
decoding its answers.
"""

import asyncio
import http.client
import json
import time
from typing import Any, Dict, List, Optional, Union

from marie_tpu_torch.excepts import BadServer
from marie_tpu_torch.logging_core import MarieLogger
from marie_tpu_torch.types.docs import Document, DocumentArray

_TRANSIENT_HTTP = (502, 503, 504)


class HTTPClient:
    def __init__(self, host: str = "127.0.0.1", port: Optional[int] = None,
                 api_key: Optional[str] = None, **kwargs):
        if port is None:
            raise ValueError("port is required")
        self.host = host.split("://", 1)[-1]
        self.port = int(port)
        self.base = f"http://{self.host}:{self.port}"
        self.logger = MarieLogger("HTTPClient")
        self._headers = {"Authorization": f"Bearer {api_key}"} if api_key else {}
        self._conn: Optional[http.client.HTTPConnection] = None
        self.last_timings: Dict[str, float] = {}

    def _request(self, method: str, path: str, body: Optional[bytes],
                 timeout: Optional[float]):
        """(status, body bytes) on the kept connection, reconnecting once
        when the server closed it."""
        headers = dict(self._headers)
        if body is not None:
            headers["Content-Type"] = "application/json"
        for attempt in (0, 1):
            if self._conn is None:
                self._conn = http.client.HTTPConnection(self.host, self.port)
            # this request's timeout, on the kept connection too
            self._conn.timeout = timeout
            if self._conn.sock is not None:
                self._conn.sock.settimeout(timeout)
            try:
                self._conn.request(method, path, body=body, headers=headers)
                resp = self._conn.getresponse()
                data = resp.read()
                if resp.will_close:
                    self.close()
                return resp.status, data
            except (http.client.RemoteDisconnected, BrokenPipeError, ConnectionResetError):
                self.close()
                if attempt:
                    raise
        raise AssertionError("unreachable")

    def post(
        self,
        on: str = "/",
        inputs: Union[DocumentArray, List[Document], None] = None,
        parameters: Optional[Dict[str, Any]] = None,
        target_executor: str = "",
        timeout: Optional[float] = None,
        return_responses: bool = False,
        request_size: int = 0,
        max_attempts: int = 1,
        initial_backoff: float = 0.1,
        max_backoff: float = 2.0,
        backoff_multiplier: float = 1.5,
        on_done=None,
        on_error=None,
        on_always=None,
        continue_on_error: bool = False,
    ):
        """Post docs to an endpoint (see the module docstring); returns
        the response documents, or with ``return_responses`` the parsed
        bodies (one body for one request)."""
        from marie_tpu_torch.clients.helper import as_docarray, chunk_docs

        timings = {"encode_s": 0.0, "wait_s": 0.0, "decode_s": 0.0}
        bodies: List[dict] = []
        for chunk in chunk_docs(as_docarray(inputs), request_size):
            t0 = time.perf_counter()
            payload = json.dumps({
                "execEndpoint": on,
                "data": chunk.to_dict(),
                "parameters": parameters or {},
                "targetExecutor": target_executor,
            }).encode()
            timings["encode_s"] += time.perf_counter() - t0
            backoff = initial_backoff
            attempt = 0
            while True:
                attempt += 1
                t0 = time.perf_counter()
                try:
                    status, raw = self._request("POST", "/post", payload, timeout)
                    if status in _TRANSIENT_HTTP and attempt < max_attempts:
                        raise ConnectionError(f"HTTP {status}")
                    break
                except (OSError, http.client.HTTPException) as ex:
                    if attempt >= max_attempts:
                        raise
                    self.logger.warning(f"retrying after {ex!r} "
                                        f"(attempt {attempt}/{max_attempts})")
                    time.sleep(backoff)
                    backoff = min(backoff * backoff_multiplier, max_backoff)
                finally:
                    timings["wait_s"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            try:
                body = json.loads(raw)
            except ValueError:
                body = None
            timings["decode_s"] += time.perf_counter() - t0
            if status >= 400:
                if on_error is not None:
                    on_error(body)
                elif not continue_on_error:
                    st = (body or {}).get("header", {}).get("status", {})
                    raise BadServer(st.get("description") or f"HTTP {status}")
            elif on_done is not None:
                on_done(body)
            if on_always is not None:
                on_always(body)
            bodies.append(body or {})
        self.last_timings = timings
        if return_responses:
            return bodies if len(bodies) > 1 else bodies[0]
        out = DocumentArray()
        t0 = time.perf_counter()
        for body in bodies:
            out.extend(DocumentArray.from_dict(body.get("data", []) or []))
        timings["decode_s"] += time.perf_counter() - t0
        return out

    async def apost(self, on: str = "/", inputs=None, **kwargs):
        """:meth:`post` on a worker thread."""
        return await asyncio.to_thread(self.post, on, inputs, **kwargs)

    def get(self, path: str, timeout: Optional[float] = 5.0):
        """(status, parsed JSON body or text) of a GET."""
        status, raw = self._request("GET", path, None, timeout)
        try:
            return status, json.loads(raw)
        except ValueError:
            return status, raw.decode(errors="replace")

    def dry_run(self, timeout: float = 5.0) -> bool:
        return self.get("/dry_run", timeout)[0] == 200

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None
