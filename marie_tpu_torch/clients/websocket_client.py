"""WebSocket client (port of ``marie_tpu/clients/websocket_client.py``) on
:mod:`marie_tpu_torch.serve.networking.ws_wire`.

Each request is one JSON message in the ``/post`` shape, sent over one
socket; the answers come back in completion order and are matched to
their requests by ``requestId``.  ``astream_doc`` is the WebSocket face of
gRPC's ``stream_doc``: a ``{"stream": true}`` message, then one message a
document and a ``done`` message.
"""

import json
import uuid
from typing import Any, Dict, List, Optional, Union

from marie_tpu_torch.clients.helper import as_docarray, chunk_docs
from marie_tpu_torch.excepts import BadServer
from marie_tpu_torch.helper import run_async
from marie_tpu_torch.logging_core import MarieLogger
from marie_tpu_torch.serve.networking import ws_wire
from marie_tpu_torch.types.docs import Document, DocumentArray


class WebSocketClient:
    def __init__(self, host: str = "127.0.0.1", port: Optional[int] = None,
                 api_key: Optional[str] = None, **kwargs):
        if port is None:
            raise ValueError("port is required")
        self.host, self.port = host, port
        self.url = f"ws://{host}:{port}/"
        self.logger = MarieLogger("WebSocketClient")
        self._headers = [("Authorization", f"Bearer {api_key}")] if api_key else []

    async def _connect(self, timeout: Optional[float] = None) -> ws_wire.WebSocket:
        return await ws_wire.connect(self.host, self.port, "/", self._headers,
                                     timeout=timeout or 60.0)

    async def apost(self, on: str = "/",
                    inputs: Union[DocumentArray, List[Document], None] = None,
                    parameters: Optional[Dict[str, Any]] = None, target_executor: str = "",
                    request_size: int = 0, timeout: Optional[float] = None,
                    return_responses: bool = False, on_done=None, on_error=None,
                    on_always=None, continue_on_error: bool = False):
        """Send ``inputs`` (``request_size`` docs a request when > 0) over
        one socket; the answers' docs in request order.  ``on_done(body)``
        a successful request, ``on_error(body)`` a failed one (in place of
        the raise), ``on_always(body)`` after each; a failed request does
        not drop the ones still in flight.  ``return_responses``: the
        answers' JSON bodies, in request order."""
        chunks = chunk_docs(as_docarray(inputs), request_size)
        results: List[Optional[dict]] = [None] * len(chunks)
        ids = {}
        ws = await self._connect(timeout)
        try:
            for i, chunk in enumerate(chunks):
                rid = uuid.uuid4().hex
                ids[rid] = i
                await ws.send_json({"header": {"requestId": rid}, "execEndpoint": on,
                                    "data": chunk.to_dict(), "parameters": parameters or {},
                                    "targetExecutor": target_executor})
            remaining = len(chunks)
            first_error: Optional[BadServer] = None
            while remaining:
                msg = await ws.receive(timeout=timeout)
                if msg.type != ws_wire.MsgType.TEXT:
                    raise BadServer(f"websocket closed early: {msg.type}")
                body = json.loads(msg.data)
                status = body.get("header", {}).get("status", {})
                err = body.get("error") or (status.get("description", "error")
                                            if status.get("code", 0) != 0 else None)
                slot = ids.get(body.get("header", {}).get("requestId", ""))
                if err is not None:
                    if slot is None:
                        # no requestId: which request failed is unknown
                        raise BadServer(err)
                    if on_error is not None:
                        on_error(body)
                    elif not continue_on_error:
                        first_error = first_error or BadServer(err)
                    if on_always is not None:
                        on_always(body)
                    remaining -= 1
                    continue
                if slot is None:
                    continue  # an answer to no request of this call
                results[slot] = body
                remaining -= 1
                if on_done is not None:
                    on_done(body)
                if on_always is not None:
                    on_always(body)
            if first_error is not None:
                raise first_error  # after every request in flight has answered
        finally:
            await ws.close()
        if return_responses:
            return results
        out = DocumentArray()
        for body in results:
            if body is not None:
                for d in DocumentArray.from_dict(body.get("data", [])):
                    out.append(d)
        return out

    async def astream_doc(self, on: str, doc: Document,
                          parameters: Optional[Dict[str, Any]] = None):
        """One document in, the documents out as the generator endpoint
        yields them."""
        ws = await self._connect()
        try:
            await ws.send_json({"execEndpoint": on, "stream": True, "data": [doc.to_dict()],
                                "parameters": parameters or {}})
            async for msg in ws:
                body = json.loads(msg.data)
                if body.get("error"):
                    raise BadServer(body["error"])
                if body.get("done"):
                    return
                yield Document.from_dict(body["doc"])
        finally:
            await ws.close()

    def post(self, on: str = "/", inputs=None, **kwargs):
        return run_async(self.apost(on=on, inputs=inputs, **kwargs))
