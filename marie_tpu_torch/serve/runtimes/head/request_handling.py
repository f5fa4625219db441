"""HeaderRequestHandler (port of ``marie_tpu/serve/runtimes/head/request_handling.py``):
the fan-out and fan-in of a sharded deployment.  ``polling=ALL``
broadcasts a request to every shard and reduces the answers (the docs
deduped by id, the routes merged); ``ANY`` sends it to one shard, round
robin; a dict maps endpoints to modes, ``"*"`` the default.  Endpoint
discovery asks the shards."""

import asyncio
from typing import Any, Dict, List, Optional, Sequence

from marie_tpu_torch.enums import PollingType
from marie_tpu_torch.logging_core import MarieLogger
from marie_tpu_torch.serve.networking import GrpcConnectionPool
from marie_tpu_torch.serve.runtimes.worker.request_handling import WorkerRequestHandler
from marie_tpu_torch.types.request import DataRequest


class HeaderRequestHandler:
    def __init__(self, shard_addresses: Dict[int, List[str]],
                 polling: PollingType = PollingType.ALL, name: str = "head",
                 timeout: Optional[float] = None, **kwargs):
        self.logger = MarieLogger(f"head/{name}")
        self.polling = polling
        self.timeout = timeout
        self.connection_pool = GrpcConnectionPool()
        self.shards = sorted(shard_addresses)
        for shard_id, addresses in shard_addresses.items():
            for addr in addresses:
                self.connection_pool.add_connection(f"shard-{shard_id}", addr)
        self._rr = 0
        self._endpoints_cache: Optional[Dict[str, Any]] = None

    def _polling_for(self, endpoint: str) -> PollingType:
        """The endpoint's polling mode: a PollingType for all, or a dict of
        endpoint -> mode with ``'*'`` as the default."""
        polling = self.polling
        if isinstance(polling, dict):
            mode = polling.get(endpoint, polling.get("*", PollingType.ALL))
        else:
            mode = polling
        if isinstance(mode, str):
            mode = PollingType[mode.upper()]
        return mode

    async def process_data(self, requests: Sequence[DataRequest]) -> DataRequest:
        req = requests[0]
        if self._polling_for(req.exec_endpoint) == PollingType.ANY:
            shard = self.shards[self._rr % len(self.shards)]
            self._rr += 1
            return await self.connection_pool.send_requests_once(
                [req], deployment=f"shard-{shard}", timeout=self.timeout)
        # ALL: broadcast, then reduce
        responses = await asyncio.gather(*(
            self.connection_pool.send_requests_once([req.copy()], deployment=f"shard-{s}",
                                                    timeout=self.timeout)
            for s in self.shards))
        for r in responses:
            if r.is_error():
                return r
        merged = WorkerRequestHandler.reduce_docs(responses)
        WorkerRequestHandler.merge_routes(responses)
        final = responses[0]
        final.docs = merged
        return final

    async def endpoints(self) -> Dict[str, Any]:
        """The shards' endpoints (the first shard that answers), so that a
        gateway filtering by endpoint sees what is behind this head; the
        ``/default`` catch-all when none answers."""
        if self._endpoints_cache is not None:
            return self._endpoints_cache
        for s in self.shards:
            try:
                info = await self.connection_pool.send_discover_endpoint(f"shard-{s}",
                                                                         timeout=5.0)
                self._endpoints_cache = info
                return info
            except Exception:  # noqa: BLE001 — try the next shard
                continue
        return {"endpoints": ["/default"], "write_endpoints": [], "schemas": {}}

    def info(self) -> Dict[str, Any]:
        from marie_tpu_torch.helper import get_full_version

        return get_full_version()

    async def close(self) -> None:
        await self.connection_pool.close()
