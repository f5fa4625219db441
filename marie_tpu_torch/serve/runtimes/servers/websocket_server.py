"""WebSocket server (port of ``marie_tpu/serve/runtimes/servers/websocket_server.py``)
on the port's HTTP server and :mod:`marie_tpu_torch.serve.networking.ws_wire`.

``GET /`` and ``/ws`` upgrade to a WebSocket; with API keys configured
the upgrade needs ``Authorization: Bearer <key>`` (401 before it).  Each
text message is one request in the ``/post`` shape; the client's
``header.requestId`` is echoed back.  Every request runs on a task of its
own, so the answers go out in completion order.  ``stream: true`` (a
generator endpoint) gives one ``doc`` message a produced document, then a
``done`` message, or an ``error`` message with ``done``.  A message that
is not JSON gets ``{"error": "invalid JSON"}`` and the socket stays open.
Closing the server closes its open sockets with 1001 and waits for each
client to answer.
"""

import asyncio
import json
from typing import Dict, Optional

from marie_tpu_torch.serve.networking import ws_wire
from marie_tpu_torch.serve.runtimes.servers.http_server import (
    HTTPServer, Upgrade, json_response, text_response)
from marie_tpu_torch.types.docs import DocumentArray
from marie_tpu_torch.types.request import DataRequest

#: how long closing the server waits for a socket's close handshake and end
_CLOSE_S = 2.0


class WebSocketServer(HTTPServer):
    def __init__(self, req_handler, port: Optional[int] = None, host: Optional[str] = None,
                 name: str = "websocket", **kwargs):
        super().__init__(req_handler, port=port, host=host, name=name,
                         routes=[("GET", "/", self._upgrade), ("GET", "/ws", self._upgrade)])
        self._sockets: Dict[ws_wire.WebSocket, asyncio.Task] = {}

    async def _upgrade(self, request):
        from marie_tpu_torch.auth import auth_enabled, validate_bearer

        if auth_enabled() and not validate_bearer(request.headers.get("authorization")):
            return json_response({"error": "missing or invalid API key"}, status=401)
        try:
            headers = ws_wire.server_handshake(request.headers)
        except ValueError as ex:
            return text_response(str(ex), 400)

        async def run(reader, writer):
            ws = ws_wire.WebSocket(reader, writer, client=False)
            self._sockets[ws] = asyncio.current_task()
            try:
                await self._session(ws)
            finally:
                self._sockets.pop(ws, None)

        return Upgrade(headers, run)

    async def _session(self, ws: ws_wire.WebSocket) -> None:
        pending = set()

        async def process(body):
            req = DataRequest.from_docs(
                DocumentArray.from_dict(body.get("data", [])),
                endpoint=body.get("execEndpoint", "/"),
                parameters=body.get("parameters") or {},
                target_executor=body.get("targetExecutor", "") or "",
            )
            # the client's requestId comes back, so that answers in
            # completion order can be matched to their requests
            client_rid = (body.get("header") or {}).get("requestId")
            if client_rid:
                req.request_id = str(client_rid)
            handler_stream = getattr(self.req_handler, "process_single_doc_stream", None)
            if body.get("stream") and handler_stream is not None:
                try:
                    async for doc in handler_stream(req):
                        await ws.send_json({"header": {"requestId": req.request_id},
                                            "doc": doc.to_dict()})
                    await ws.send_json({"header": {"requestId": req.request_id},
                                        "done": True})
                except Exception as ex:  # noqa: BLE001 — the error is the last message
                    await ws.send_json({"header": {"requestId": req.request_id},
                                        "error": repr(ex), "done": True})
                return
            resp = await self.req_handler.process_data([req])
            await ws.send_json({
                "header": {"requestId": resp.request_id,
                           "status": {"code": int(resp.status.code),
                                      "description": resp.status.description}},
                "data": resp.docs.to_dict(),
                "parameters": resp.parameters,
            })

        try:
            async for msg in ws:
                if msg.type != ws_wire.MsgType.TEXT:
                    continue
                try:
                    body = json.loads(msg.data)
                except json.JSONDecodeError:
                    await ws.send_json({"error": "invalid JSON"})
                    continue
                task = asyncio.create_task(process(body))
                pending.add(task)
                task.add_done_callback(pending.discard)
        finally:
            for task in pending:
                task.cancel()

    async def shutdown(self) -> None:
        """Close the open sockets (1001), let their connections end, then
        stop the server."""
        sockets = dict(self._sockets)
        if sockets:
            await asyncio.wait([asyncio.ensure_future(
                ws.close(ws_wire.CloseCode.GOING_AWAY, b"Server shutdown", timeout=_CLOSE_S))
                for ws in sockets], timeout=_CLOSE_S)
            await asyncio.wait(list(sockets.values()), timeout=_CLOSE_S)
        await super().shutdown()

    @property
    def address(self) -> str:
        host = "127.0.0.1" if self.host == "0.0.0.0" else self.host
        return f"ws://{host}:{self.port}"
