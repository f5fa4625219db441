"""gRPC client (port of ``marie_tpu/clients/grpc_client.py``) on the
standard library's transport (:mod:`marie_tpu_torch.serve.networking.grpc_wire`).

``GRPCClient(port=...).post(on, inputs, parameters=...)`` sends documents
to ``jina.JinaDataRequestRPC/process_data`` and returns the response's
documents, with the JAX client's options: ``request_size`` chunking,
retries with exponential backoff on UNAVAILABLE and DEADLINE_EXCEEDED,
``on_done`` / ``on_error`` / ``on_always`` callbacks, ``continue_on_error``
and ``return_responses``.  ``astream`` is the bidirectional
``jina.JinaRPC/Call`` (``results_in_order`` asks a gateway for
submission order), ``astream_doc`` the server-streaming ``stream_doc``;
``adry_run``, ``ainfo`` and ``aprofiling`` as in the JAX client, each with
a sync form.  The async calls of one event loop share one HTTP/2
connection (:meth:`aclose` ends it); a sync call makes its own.
``wire_mode="docs"`` sends the documents as a ``DocListProto`` in place of
JSON, and the answer comes back in the same form.  Each request of
``apost`` runs in a ``client/post`` span, and every call carries the active
trace context as W3C ``traceparent`` metadata.
"""

import asyncio
import time
from datetime import datetime
from typing import Any, Dict, List, Optional, Union

from marie_tpu_torch.excepts import BadServer
from marie_tpu_torch.helper import run_async
from marie_tpu_torch.logging_core import MarieLogger
from marie_tpu_torch.proto import messages
from marie_tpu_torch.serve.instrumentation import tracing
from marie_tpu_torch.serve.networking.grpc_wire import (
    COMPRESSION, MAX_MESSAGE, Channel, RpcError, StatusCode)
from marie_tpu_torch.types.docs import Document, DocumentArray
from marie_tpu_torch.types.request import DataRequest, to_request_list_bytes

_PROCESS_DATA = "/jina.JinaDataRequestRPC/process_data"
_DRY_RUN = "/jina.JinaGatewayDryRunRPC/dry_run"
_INFO = "/jina.JinaInfoRPC/_status"
_CALL = "/jina.JinaRPC/Call"
_STREAM_DOC = "/jina.JinaSingleDocumentRequestRPC/stream_doc"
_HEALTH = "/grpc.health.v1.Health/Check"


class GRPCClient:
    def __init__(self, host: str = "127.0.0.1", port: Optional[int] = None,
                 api_key: Optional[str] = None, compression: Optional[str] = None,
                 wire_mode: str = "docs_bytes", **kwargs):
        if port is None:
            raise ValueError("port is required")
        self.address = f"{host}:{port}"
        self.logger = MarieLogger("GRPCClient")
        # sent as `authorization: Bearer <key>` metadata on every call
        self._metadata = (("authorization", f"Bearer {api_key}"),) if api_key else None
        # channel-default message compression ("Gzip" / "Deflate" / "NoCompression")
        self._compression = COMPRESSION[compression] if compression else None
        if wire_mode not in ("docs_bytes", "docs"):
            raise ValueError(f"unknown wire mode {wire_mode!r}")
        self.wire_mode = wire_mode
        self._ch: Optional[Channel] = None
        self._ch_loop = None

    def _channel(self) -> Channel:
        """The running loop's channel (made on first use in that loop)."""
        loop = asyncio.get_running_loop()
        if self._ch is None or self._ch_loop is not loop:
            self._ch = Channel(self.address, compression=self._compression,
                               max_message=MAX_MESSAGE)
            self._ch_loop = loop
        return self._ch

    async def aclose(self) -> None:
        if self._ch is not None and self._ch_loop is asyncio.get_running_loop():
            await self._ch.close()
        self._ch = self._ch_loop = None

    def _metadata_now(self):
        """The call's metadata: the key's, then the active traceparent."""
        return tracing.inject_metadata(self._metadata) or None

    def _request(self, docs, on: str, parameters, target_executor: str) -> DataRequest:
        req = DataRequest.from_docs(docs, endpoint=on, parameters=parameters,
                                    target_executor=target_executor)
        req.wire_mode = self.wire_mode
        return req

    # --- async API ----------------------------------------------------
    async def apost(self, on: str = "/",
                    inputs: Union[DocumentArray, List[Document], None] = None,
                    parameters: Optional[Dict[str, Any]] = None, target_executor: str = "",
                    timeout: Optional[float] = None, return_responses: bool = False,
                    request_size: int = 0, max_attempts: int = 1,
                    initial_backoff: float = 0.1, max_backoff: float = 2.0,
                    backoff_multiplier: float = 1.5, on_done=None, on_error=None,
                    on_always=None, continue_on_error: bool = False):
        """Post docs to an endpoint.  ``inputs``: a DocumentArray, list or
        generator; ``request_size`` > 0 chunks it into requests of that many
        docs.  UNAVAILABLE / DEADLINE_EXCEEDED retry up to
        ``max_attempts`` with exponential backoff.  ``on_error(resp)``
        takes a failed response in place of the raise.  With
        ``return_responses`` one request returns its response, several
        their list."""
        from marie_tpu_torch.clients.helper import as_docarray, chunk_docs

        chunks = chunk_docs(as_docarray(inputs), request_size)
        responses: List[DataRequest] = []
        ch = self._channel()
        for chunk in chunks:
            req = self._request(chunk, on, parameters, target_executor)
            payload = to_request_list_bytes([req])
            backoff = initial_backoff
            attempt = 0
            while True:
                attempt += 1
                try:
                    with tracing.start_span("client/post", {"endpoint": on,
                                                            "request_id": req.request_id}):
                        raw = await ch.unary_unary(_PROCESS_DATA, payload, timeout=timeout,
                                                   metadata=self._metadata_now())
                    resp = DataRequest.from_bytes(raw)
                    break
                except RpcError as ex:
                    retriable = ex.code() in (StatusCode.UNAVAILABLE,
                                              StatusCode.DEADLINE_EXCEEDED)
                    if not retriable or attempt >= max_attempts:
                        raise
                    self.logger.warning(f"retrying after {ex.code().name} "
                                        f"(attempt {attempt}/{max_attempts})")
                    await asyncio.sleep(backoff)
                    backoff = min(backoff * backoff_multiplier, max_backoff)
            if resp.is_error():
                if on_error is not None:
                    on_error(resp)
                elif not continue_on_error:
                    st = resp.status
                    raise BadServer(f"request failed in {st.exception.executor or 'server'}: "
                                    f"{st.description}")
            elif on_done is not None:
                on_done(resp)
            if on_always is not None:
                on_always(resp)
            responses.append(resp)
        if return_responses:
            return responses if len(responses) > 1 else responses[0]
        out = DocumentArray()
        for resp in responses:
            for d in resp.docs:
                out.append(d)
        return out

    async def adry_run(self, timeout: float = 5.0) -> bool:
        raw = await self._channel().unary_unary(_DRY_RUN, b"", timeout=timeout,
                                                metadata=self._metadata_now())
        return messages.decode("jina.StatusProto", raw).get("code", 0) == \
            messages.STATUS_SUCCESS

    async def ahealth(self, timeout: float = 5.0) -> int:
        """``grpc.health.v1.Health/Check``: the serving status (1 SERVING)."""
        raw = await self._channel().unary_unary(_HEALTH, b"", timeout=timeout)
        return messages.decode("grpc.health.v1.HealthCheckResponse", raw).get("status", 0)

    async def ainfo(self, timeout: float = 5.0) -> dict:
        import json

        raw = await self._channel().unary_unary(_INFO, b"", timeout=timeout,
                                                metadata=self._metadata_now())

        def _maybe_json(v):
            try:
                return json.loads(v)
            except (ValueError, TypeError):
                return v

        return {k: _maybe_json(v)
                for k, v in messages.decode("jina.JinaInfoProto", raw).get("jina", {}).items()}

    async def astream(self, requests_iter, timeout: Optional[float] = None,
                      results_in_order: bool = False):
        """Bidirectional streaming over ``jina.JinaRPC/Call``: responses in
        completion order, or in submission order with
        ``results_in_order`` (the gateway keeps it)."""
        async def encoded():
            if hasattr(requests_iter, "__aiter__"):
                async for r in requests_iter:
                    yield mark(r).to_bytes()
            else:
                for r in requests_iter:
                    yield mark(r).to_bytes()

        def mark(r: DataRequest) -> DataRequest:
            if results_in_order:
                params = r.parameters
                params["__results_in_order__"] = True
                r.parameters = params
            return r

        async for raw in self._channel().stream_stream(_CALL, encoded(), timeout=timeout,
                                                       metadata=self._metadata_now()):
            yield DataRequest.from_bytes(raw)

    async def astream_doc(self, on: str, doc: Document,
                          parameters: Optional[Dict[str, Any]] = None,
                          timeout: Optional[float] = None):
        """One document in, a stream of documents out, yielded as the
        server produces them (``stream_doc``: generator endpoints)."""
        sreq = messages.encode("jina.SingleDocumentRequestProto", {
            "header": {"exec_endpoint": on},
            "parameters": messages.py_to_struct(parameters or {}),
            "document": doc.to_docarray_proto()})
        async for raw in self._channel().unary_stream(_STREAM_DOC, sreq, timeout=timeout,
                                                      metadata=self._metadata_now()):
            resp = messages.decode("jina.SingleDocumentRequestProto", raw)
            yield Document.from_docarray_proto(resp.get("document", {}))

    async def aprofiling(self, timeout: Optional[float] = None) -> Dict[str, Any]:
        """Round-trip latency: total client seconds and each executor's
        from the response's routes."""
        req = DataRequest.from_docs(DocumentArray(), endpoint="/")
        t0 = time.perf_counter()
        # an error response still carries routes: this measures latency
        raw = await self._channel().unary_unary(_PROCESS_DATA, to_request_list_bytes([req]),
                                                timeout=timeout, metadata=self._metadata_now())
        resp = DataRequest.from_bytes(raw)
        total = time.perf_counter() - t0
        routes = {}
        for r in resp.routes:
            try:
                start = datetime.fromisoformat(r.start_time)
                end = datetime.fromisoformat(r.end_time)
                routes[r.executor] = (end - start).total_seconds()
            except ValueError:
                routes[r.executor] = None
        network = total - sum(v for v in routes.values() if v)
        return {"total_seconds": round(total, 6), "executors": routes,
                "network_and_gateway_seconds": round(max(network, 0.0), 6)}

    # --- sync wrappers -------------------------------------------------
    def _sync(self, coro):
        async def run():
            try:
                return await coro
            finally:
                await self.aclose()

        return run_async(run())

    def post(self, on: str = "/", inputs=None, **kwargs):
        return self._sync(self.apost(on=on, inputs=inputs, **kwargs))

    def profiling(self, **kwargs) -> Dict[str, Any]:
        return self._sync(self.aprofiling(**kwargs))

    def dry_run(self, **kwargs) -> bool:
        return self._sync(self.adry_run(**kwargs))

    def health(self, **kwargs) -> int:
        return self._sync(self.ahealth(**kwargs))

    async def is_flow_ready(self, **kwargs) -> bool:
        try:
            return await self.adry_run(**kwargs)
        except Exception:  # noqa: BLE001 — a readiness probe never raises
            return False

    def flow_ready(self, **kwargs) -> bool:
        return self._sync(self.is_flow_ready(**kwargs))

    def info(self, **kwargs) -> dict:
        return self._sync(self.ainfo(**kwargs))
