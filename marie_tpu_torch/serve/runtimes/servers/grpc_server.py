"""gRPC server (port of ``marie_tpu/serve/runtimes/servers/grpc_server.py``)
on the standard library's transport (:mod:`marie_tpu_torch.serve.networking.grpc_wire`).

The JAX server's services, under the same service and method names:
``jina.JinaDataRequestRPC/process_data`` (a ``DataRequestListProto`` in,
one ``DataRequestProto`` out), ``jina.JinaSingleDataRequestRPC/
process_single_data``, ``jina.JinaRPC/Call`` (bidirectional; the
gateway's prefetching ``stream`` when the handler has one, else one
request at a time), ``jina.JinaSingleDocumentRequestRPC/stream_doc`` (one
document in, the documents out as the handler yields them),
``jina.JinaDiscoverEndpointsRPC/endpoint_discovery``,
``jina.JinaInfoRPC/_status``, ``jina.JinaGatewayDryRunRPC/dry_run``,
snapshot and restore with their progress calls (a restore is confined to
the snapshot directory), and ``grpc.health.v1.Health/Check``.  With API
keys configured every call but the health check needs
``authorization: Bearer <key>`` metadata (UNAUTHENTICATED otherwise).

The handler's model work leaves the event loop (the executor's sync
endpoints run on the loop's thread pool, the engine's page programs on
its kept device thread), so a long request does not hold up the PINGs,
WINDOW_UPDATEs and other streams of the connection.  A call's W3C
``traceparent`` metadata is adopted (``serve/instrumentation/tracing.py``):
each request runs in an ``rpc/<handler name>`` span under the caller's
context, and the gateway's bidirectional stream in an ``rpc-stream/`` one.
"""

import asyncio
import json
import os
import tempfile
import uuid
from collections import OrderedDict
from typing import Optional

from marie_tpu_torch.logging_core import MarieLogger
from marie_tpu_torch.proto import messages
from marie_tpu_torch.serve.instrumentation import tracing
from marie_tpu_torch.serve.networking import grpc_wire
from marie_tpu_torch.serve.networking.grpc_wire import (
    COMPRESSION, STREAM_STREAM, UNARY_STREAM, UNARY_UNARY, StatusCode)
from marie_tpu_torch.types.request import DataRequest, from_request_list_bytes

_MAX_MSG = grpc_wire.MAX_MESSAGE
#: where snapshots are written, and the only place a restore reads (the
#: JAX server's ``/tmp/marie/snapshots``, under the process's temp directory)
SNAPSHOT_DIR = os.path.join(tempfile.gettempdir(), "marie", "snapshots")



class _HealthServicer:
    """grpc.health.v1.Health: SERVING by default."""

    def __init__(self):
        self.status = messages.HEALTH_SERVING

    async def check(self, request: bytes, context) -> bytes:
        return messages.encode("grpc.health.v1.HealthCheckResponse", {"status": self.status})


class GRPCServer:
    """Serves a request handler (worker / gateway / head) over gRPC."""

    _STATUS_CAP = 256

    def __init__(self, req_handler, port: Optional[int] = None, host: Optional[str] = None,
                 name: str = "grpc", compression: Optional[str] = None, **kwargs):
        from marie_tpu_torch.helper import default_bind_host

        self.req_handler = req_handler
        self.port = port or 0  # 0: a free port, known after setup_server
        self.host = host or default_bind_host()
        self.name = name
        # server-default response compression ("Gzip" / "Deflate")
        self.compression = COMPRESSION[compression] if compression else None
        self.logger = MarieLogger(f"GRPCServer/{name}")
        self.server: Optional[grpc_wire.Server] = None
        self.health = _HealthServicer()
        # id -> serialized status, for the *Progress services (LRU-capped)
        self._snapshot_status: "OrderedDict[str, bytes]" = OrderedDict()
        self._restore_status: "OrderedDict[str, bytes]" = OrderedDict()

    @classmethod
    def _record_status(cls, store, key: str, value: bytes) -> None:
        store[key] = value
        store.move_to_end(key)
        while len(store) > cls._STATUS_CAP:
            store.popitem(last=False)

    # -- the services ----------------------------------------------------
    def _span_name(self, prefix: str) -> str:
        return f"{prefix}/{getattr(self.req_handler, 'name', 'handler')}"

    async def _process(self, requests, context) -> bytes:
        if isinstance(requests, DataRequest):
            requests = [requests]
        # adopt the caller's W3C traceparent
        with tracing.activate(tracing.extract_metadata(context.invocation_metadata())):
            with tracing.start_span(self._span_name("rpc"),
                                    {"request_id": requests[0].request_id,
                                     "endpoint": requests[0].exec_endpoint}):
                resp = await self.req_handler.process_data(requests)
        out = resp.to_bytes()
        recorder = getattr(self.req_handler, "record_response_bytes", None)
        if recorder is not None:
            recorder(len(out))
        return out

    async def process_data(self, request: bytes, context) -> bytes:
        return await self._process(from_request_list_bytes(request), context)

    async def process_single_data(self, request: bytes, context) -> bytes:
        return await self._process(DataRequest.from_bytes(request), context)

    async def call_stream(self, request_iterator, context):
        async def requests():
            async for raw in request_iterator:
                yield DataRequest.from_bytes(raw)

        handler_stream = getattr(self.req_handler, "stream", None)
        if handler_stream is not None:
            # the gateway: requests in flight at once, answered in completion
            # order (or in submission order when the client asks)
            with tracing.start_span(self._span_name("rpc-stream")):
                async for resp in handler_stream(requests()):
                    yield resp.to_bytes()
            return
        async for req in requests():
            yield await self._process(req, context)

    async def endpoint_discovery(self, request: bytes, context) -> bytes:
        eps = self.req_handler.endpoints()
        if asyncio.iscoroutine(eps):
            eps = await eps  # heads ask their shards
        return messages.encode("jina.EndpointsProto", {
            "endpoints": list(eps["endpoints"]),
            "write_endpoints": list(eps.get("write_endpoints", [])),
            "schemas": messages.py_to_struct(eps.get("schemas", {}))})

    async def status(self, request: bytes, context) -> bytes:
        info = {str(k): v if isinstance(v, str) else json.dumps(v)
                for k, v in (self.req_handler.info() or {}).items()}
        return messages.encode("jina.JinaInfoProto", {"jina": info})

    async def dry_run(self, request: bytes, context) -> bytes:
        st = {"code": messages.STATUS_SUCCESS}
        try:
            if hasattr(self.req_handler, "dry_run"):
                await self.req_handler.dry_run()
        except Exception as ex:  # noqa: BLE001 — the answer carries the failure
            st = {"code": messages.STATUS_ERROR, "description": repr(ex)}
        return messages.encode("jina.StatusProto", st)

    async def stream_doc(self, request: bytes, context):
        """One document in, a stream of processed documents out."""
        from marie_tpu_torch.types.docs import Document, DocumentArray

        single = messages.decode("jina.SingleDocumentRequestProto", request)
        header = single.get("header", {})
        req = DataRequest()
        if header.get("request_id"):
            req.request_id = header["request_id"]
        if header.get("exec_endpoint"):
            req.exec_endpoint = header["exec_endpoint"]
        params = single.get("parameters", {})
        if params.get("fields"):
            req.parameters = messages.struct_to_py(params)
        if single.get("document", {}).get("data"):
            req.docs = DocumentArray([Document.from_docarray_proto(single["document"])])

        def out(header_wire, doc) -> bytes:
            return messages.encode("jina.SingleDocumentRequestProto", {
                "header": header_wire, "parameters": params,
                "document": doc.to_docarray_proto()})

        handler_stream = getattr(self.req_handler, "process_single_doc_stream", None)
        if handler_stream is not None:
            # generator endpoints stream documents as they are produced
            async for doc in handler_stream(req):
                yield out(req.header.to_wire(), doc)
            return
        resp = await self.req_handler.process_data([req])
        for doc in resp.docs:
            yield out(resp.header.to_wire(), doc)

    def _snapshot_file(self, sid: str) -> str:
        return os.path.join(SNAPSHOT_DIR, sid)

    async def snapshot(self, request: bytes, context) -> bytes:
        proto = {"id": {"value": uuid.uuid4().hex}}
        try:
            snapshot_file = self._snapshot_file(proto["id"]["value"])
            os.makedirs(os.path.dirname(snapshot_file), exist_ok=True)
            self.req_handler.snapshot(snapshot_file)
            proto["status"] = messages.SNAPSHOT_SUCCEEDED
            proto["snapshot_file"] = snapshot_file
        except Exception as ex:  # noqa: BLE001 — the answer carries the failure
            self.logger.error(f"snapshot failed: {ex!r}")
            proto["status"] = messages.SNAPSHOT_FAILED
        raw = messages.encode("jina.SnapshotStatusProto", proto)
        self._record_status(self._snapshot_status, proto["id"]["value"], raw)
        return raw

    async def snapshot_status(self, request: bytes, context) -> bytes:
        sid = messages.decode("jina.SnapshotId", request).get("value", "")
        known = self._snapshot_status.get(sid)
        if known is not None:
            return known
        return messages.encode("jina.SnapshotStatusProto", {
            "id": {"value": sid}, "status": messages.SNAPSHOT_NOT_FOUND})

    async def restore(self, request: bytes, context) -> bytes:
        """Restore the executor from a snapshot; the path is the client's,
        so it must resolve inside the snapshot directory."""
        cmd = messages.decode("jina.RestoreSnapshotCommand", request)
        proto = {"id": {"value": uuid.uuid4().hex}}
        try:
            snapshot_dir = os.path.realpath(SNAPSHOT_DIR)
            path = cmd.get("snapshot_file", "")
            resolved = os.path.realpath(path)
            if not resolved.startswith(snapshot_dir + os.sep):
                raise PermissionError(f"restore path {path!r} outside the snapshot directory")
            self.req_handler.restore(resolved)
            proto["status"] = messages.RESTORE_SUCCEEDED
        except Exception as ex:  # noqa: BLE001 — the answer carries the failure
            self.logger.error(f"restore failed: {ex!r}")
            proto["status"] = messages.RESTORE_FAILED
        raw = messages.encode("jina.RestoreSnapshotStatusProto", proto)
        self._record_status(self._restore_status, proto["id"]["value"], raw)
        return raw

    async def restore_status(self, request: bytes, context) -> bytes:
        rid = messages.decode("jina.RestoreId", request).get("value", "")
        known = self._restore_status.get(rid)
        if known is not None:
            return known
        return messages.encode("jina.RestoreSnapshotStatusProto", {
            "id": {"value": rid}, "status": messages.RESTORE_NOT_FOUND})

    # -- transport -------------------------------------------------------
    @staticmethod
    async def _check_auth(context) -> None:
        """UNAUTHENTICATED when keys are configured and the call carries no
        valid ``authorization: Bearer`` metadata."""
        from marie_tpu_torch.auth import auth_enabled, validate_bearer

        if not auth_enabled():
            return
        md = dict(context.invocation_metadata() or ())
        if not validate_bearer(md.get("authorization")):
            await context.abort(StatusCode.UNAUTHENTICATED, "missing or invalid API key")

    def _guarded(self, kind: str, fn):
        check = self._check_auth
        if kind == UNARY_UNARY:
            async def wrapped(request, context):
                await check(context)
                return await fn(request, context)
        else:
            async def wrapped(request, context):
                await check(context)
                async for item in fn(request, context):
                    yield item
        return wrapped

    async def setup_server(self) -> None:
        self.server = grpc_wire.Server(compression=self.compression, max_message=_MAX_MSG)
        services = {
            "jina.JinaDataRequestRPC/process_data": (UNARY_UNARY, self.process_data),
            "jina.JinaSingleDataRequestRPC/process_single_data":
                (UNARY_UNARY, self.process_single_data),
            "jina.JinaRPC/Call": (STREAM_STREAM, self.call_stream),
            "jina.JinaSingleDocumentRequestRPC/stream_doc": (UNARY_STREAM, self.stream_doc),
            "jina.JinaDiscoverEndpointsRPC/endpoint_discovery":
                (UNARY_UNARY, self.endpoint_discovery),
            "jina.JinaInfoRPC/_status": (UNARY_UNARY, self.status),
            "jina.JinaGatewayDryRunRPC/dry_run": (UNARY_UNARY, self.dry_run),
            "jina.JinaExecutorSnapshot/snapshot": (UNARY_UNARY, self.snapshot),
            "jina.JinaExecutorSnapshotProgress/snapshot_status":
                (UNARY_UNARY, self.snapshot_status),
            "jina.JinaExecutorRestore/restore": (UNARY_UNARY, self.restore),
            "jina.JinaExecutorRestoreProgress/restore_status": (UNARY_UNARY, self.restore_status),
        }
        for path, (kind, fn) in services.items():
            self.server.add_method("/" + path, kind, self._guarded(kind, fn))
        # health probes stay open so orchestrators can see readiness
        self.server.add_method("/grpc.health.v1.Health/Check", UNARY_UNARY, self.health.check)
        self.port = await self.server.start(self.host, self.port)
        self.logger.debug(f"gRPC server serving on {self.host}:{self.port}")

    async def run_server(self) -> None:
        while True:  # the server runs inside the loop; park
            await asyncio.sleep(3600)

    async def shutdown(self) -> None:
        # the runtime owns the handler's lifecycle; the server stops the transport
        if self.server is not None:
            await self.server.stop(grace=1.0)
            self.server = None

    @property
    def address(self) -> str:
        return f"{'127.0.0.1' if self.host == '0.0.0.0' else self.host}:{self.port}"
