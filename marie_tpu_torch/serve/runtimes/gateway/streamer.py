"""GatewayStreamer (port of ``marie_tpu/serve/runtimes/gateway/streamer.py``):
requests through the DAG with at most ``prefetch`` in flight, and
:class:`ExecutorStreamer` for one deployment directly."""

import asyncio
from typing import AsyncIterator, Dict, List, Optional, Sequence

from marie_tpu_torch.logging_core import MarieLogger
from marie_tpu_torch.serve.networking import GrpcConnectionPool
from marie_tpu_torch.serve.runtimes.gateway.topology_graph import TopologyGraph
from marie_tpu_torch.types.request import DataRequest


class GatewayStreamer:
    def __init__(self, graph_representation: Dict[str, List[str]],
                 executor_addresses: Dict[str, List[str]], prefetch: int = 0,
                 timeout: Optional[float] = None,
                 floating_deployments: Optional[Sequence[str]] = None,
                 balancer: str = "round_robin", node_conditions=None):
        self.logger = MarieLogger("GatewayStreamer")
        self.topology = TopologyGraph(graph_representation,
                                      floating_deployments=floating_deployments,
                                      node_conditions=node_conditions)
        self.connection_pool = GrpcConnectionPool(balancer=balancer)
        for deployment, addresses in executor_addresses.items():
            for addr in addresses:
                self.connection_pool.add_connection(deployment, addr)
        self.prefetch = prefetch
        self.timeout = timeout
        self._sem = asyncio.Semaphore(prefetch) if prefetch and prefetch > 0 else None

    async def process_single_data(self, request: DataRequest) -> DataRequest:
        if self._sem is not None:
            async with self._sem:
                return await self.topology.stream(request, self.connection_pool, self.timeout)
        return await self.topology.stream(request, self.connection_pool, self.timeout)

    async def _process_guarded(self, request: DataRequest) -> DataRequest:
        """A failure of one request becomes its error envelope, so that the
        other requests of a stream go on."""
        try:
            return await self.process_single_data(request)
        except Exception as ex:  # noqa: BLE001 — degrade per request
            self.logger.error(f"request failed in DAG stream: {ex!r}")
            request.add_exception(ex)
            return request

    async def stream(self, request_iterator: AsyncIterator[DataRequest],
                     results_in_order: bool = False) -> AsyncIterator[DataRequest]:
        """The requests processed concurrently; answers in completion order,
        or in submission order with ``results_in_order``."""
        if results_in_order:
            ordered: asyncio.Queue = asyncio.Queue()
            done_marker = object()

            async def feed_ordered():
                async for req in request_iterator:
                    ordered.put_nowait(asyncio.create_task(self._process_guarded(req)))
                ordered.put_nowait(done_marker)

            feeder = asyncio.create_task(feed_ordered())
            try:
                while True:
                    item = await ordered.get()
                    if item is done_marker:
                        break
                    yield await item
            finally:
                feeder.cancel()
            return
        queue: asyncio.Queue = asyncio.Queue()
        n_pending = 0
        done_feeding = asyncio.Event()

        async def feed():
            nonlocal n_pending
            async for req in request_iterator:
                n_pending += 1
                task = asyncio.create_task(self._process_guarded(req))
                task.add_done_callback(queue.put_nowait)
            done_feeding.set()

        feeder = asyncio.create_task(feed())
        try:
            while not (done_feeding.is_set() and n_pending == 0):
                get_task = asyncio.create_task(queue.get())
                wait_done = asyncio.create_task(done_feeding.wait())
                done, pending = await asyncio.wait([get_task, wait_done],
                                                   return_when=asyncio.FIRST_COMPLETED)
                for p in pending:
                    p.cancel()
                if get_task in done:
                    task = get_task.result()
                    n_pending -= 1
                    if task.exception() is not None:
                        raise task.exception()
                    yield task.result()
        finally:
            feeder.cancel()

    def update_topology(self, graph_representation: Dict[str, List[str]],
                        executor_addresses: Dict[str, List[str]],
                        floating_deployments: Optional[Sequence[str]] = None) -> None:
        """Rebuild the routing live, keeping the channels of addresses that
        stay."""
        self.topology = TopologyGraph(graph_representation,
                                      floating_deployments=floating_deployments)
        for deployment, addresses in executor_addresses.items():
            existing = set(self.connection_pool.addresses(deployment))
            for addr in addresses:
                if addr not in existing:
                    self.connection_pool.add_connection(deployment, addr)
            for addr in existing - set(addresses):
                self.connection_pool.remove_connection(deployment, addr)

    async def close(self) -> None:
        await self.connection_pool.close()


class ExecutorStreamer:
    """Address one deployment directly."""

    def __init__(self, connection_pool: GrpcConnectionPool, executor_name: str):
        self.connection_pool = connection_pool
        self.executor_name = executor_name

    async def post(self, docs, exec_endpoint: str = "/", parameters=None):
        req = DataRequest.from_docs(docs, endpoint=exec_endpoint, parameters=parameters)
        resp = await self.connection_pool.send_requests_once([req],
                                                             deployment=self.executor_name)
        return resp.docs
