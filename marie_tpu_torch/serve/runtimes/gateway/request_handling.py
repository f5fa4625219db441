"""GatewayRequestHandler (port of
``marie_tpu/serve/runtimes/gateway/request_handling.py``): the flow's
entry handler over a :class:`GatewayStreamer`, with the worker's handler
interface, so that the same servers serve both.  ``start_discovery``
takes the routing from the discovery registry and rebuilds it as workers
come and go."""

import asyncio
import json
import time
from typing import Any, Dict, List, Optional, Sequence

from marie_tpu_torch.logging_core import MarieLogger
from marie_tpu_torch.proto import messages
from marie_tpu_torch.serve.runtimes.gateway.streamer import GatewayStreamer
from marie_tpu_torch.types.request import DataRequest


class GatewayRequestHandler:
    def __init__(self, graph_representation: Dict[str, List[str]],
                 executor_addresses: Dict[str, List[str]], prefetch: int = 0,
                 timeout: Optional[float] = None,
                 floating_deployments: Optional[Sequence[str]] = None,
                 node_conditions: Optional[Dict[str, Any]] = None, name: str = "gateway",
                 **kwargs):
        self.logger = MarieLogger(f"gateway/{name}")
        self.streamer = GatewayStreamer(graph_representation, executor_addresses,
                                        prefetch=prefetch, timeout=timeout,
                                        floating_deployments=floating_deployments,
                                        node_conditions=node_conditions)
        from marie_tpu_torch.metrics import MetricUnit, get_registry

        reg = get_registry()
        dims = {"runtime": "gateway", "name": name}
        self._m_latency = reg.metric("request_seconds", MetricUnit.SECONDS, dims)
        self._m_docs = reg.metric("request_docs", MetricUnit.COUNT, dims)
        self._m_failed = reg.metric("failed_requests", MetricUnit.COUNT, dims)

    async def process_data(self, requests: Sequence[DataRequest]) -> DataRequest:
        t0 = time.perf_counter()
        try:
            resp = await self.streamer.process_single_data(requests[0])
        except Exception as ex:  # noqa: BLE001 — a dead deployment is an error
            # envelope, not a gateway crash
            self.logger.error(f"DAG processing failed: {ex!r}")
            resp = requests[0]
            resp.add_exception(ex)
        self._m_latency.record(time.perf_counter() - t0)
        self._m_docs.record(len(resp.docs))
        if resp.is_error():
            self._m_failed.record(1)
        return resp

    async def process_single_doc_stream(self, req: DataRequest):
        """One document in, a stream of documents out, as the worker's
        generator endpoint yields them; sent to ``target_executor``, else
        to the flow's one deployment.  A flow of several deployments
        without a target runs the whole DAG and yields its docs."""
        from marie_tpu_torch.types.docs import Document

        deployments = self.streamer.connection_pool.deployments()
        target = req.target_executor or None
        if target is None and len(deployments) != 1:
            resp = await self.process_data([req])
            for d in resp.docs:
                yield d
            return
        if target is None:
            target = deployments[0]
        elif target not in deployments:
            raise ValueError(f"unknown target_executor {target!r} (flow has {deployments})")
        single = {"header": {"request_id": req.request_id, "exec_endpoint": req.exec_endpoint},
                  "parameters": messages.py_to_struct(req.parameters or {})}
        if len(req.docs):
            single["document"] = req.docs[0].to_docarray_proto()
        async for item in self.streamer.connection_pool.stream_single_doc(
                single, target, timeout=self.streamer.timeout):
            yield Document.from_docarray_proto(item.get("document", {}))

    async def start_discovery(self, discovery_address: str, prefix: str = "gateway/") -> None:
        """Watch the registry and rebuild the streamer when workers come
        and go.  Workers register as ``<prefix><deployment>/<name>`` with
        ``{"address": "host:port"}`` under a lease; its expiry or delete
        takes them out of the routing.  Each deployment hangs off the
        gateway on its own; an empty prefix keeps the last topology."""
        from marie_tpu_torch.serve.discovery import DiscoveryClient

        self._discovery = DiscoveryClient(discovery_address)
        self._discovery_prefix = prefix

        async def rebuild():
            items = await self._discovery.get_prefix(prefix)
            deployments: Dict[str, List[str]] = {}
            for key, raw in items.items():
                deployment = key[len(prefix):].split("/")[0]
                try:
                    address = json.loads(raw)["address"]
                except (json.JSONDecodeError, KeyError):
                    address = raw
                deployments.setdefault(deployment, []).append(address)
            if not deployments:
                return
            graph = {"start-gateway": list(deployments)}
            for d in deployments:
                graph[d] = ["end-gateway"]
            self.streamer.update_topology(graph, deployments)
            self.logger.info(f"topology rebuilt from discovery: {sorted(deployments)}")

        await rebuild()

        def on_event(event: dict) -> None:
            asyncio.get_running_loop().create_task(rebuild())

        self._watch_task = await self._discovery.watch(prefix, on_event)

    async def stop_discovery(self) -> None:
        task = getattr(self, "_watch_task", None)
        if task is not None:
            task.cancel()
        client = getattr(self, "_discovery", None)
        if client is not None:
            await client.close()

    async def stream(self, request_iterator):
        """The bidirectional stream: order kept when the first request
        carries ``__results_in_order__``."""
        it = request_iterator.__aiter__()
        try:
            first = await it.__anext__()
        except StopAsyncIteration:
            return
        in_order = bool((first.parameters or {}).get("__results_in_order__"))

        async def chained():
            yield first
            async for r in it:
                yield r

        async for resp in self.streamer.stream(chained(), results_in_order=in_order):
            yield resp

    async def dry_run(self) -> None:
        """Ask every deployment's endpoints."""
        for deployment in self.streamer.connection_pool.deployments():
            await self.streamer.connection_pool.send_discover_endpoint(deployment)

    def endpoints(self) -> Dict[str, Any]:
        return {"endpoints": ["/"], "write_endpoints": [], "schemas": {}}

    def info(self) -> Dict[str, Any]:
        from marie_tpu_torch.helper import get_full_version

        return get_full_version()

    async def close(self) -> None:
        await self.streamer.close()
