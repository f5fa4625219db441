"""Dynamic batching queue (copy of
``marie_tpu/serve/runtimes/worker/batch_queue.py``): per endpoint and
parameter set, requests accumulate until ``preferred_batch_size`` docs are
queued or ``timeout`` ms elapse, then the merged batch runs once and the
results are split back to the requests in order; ``flush_all`` drains the
whole queue at once."""

import asyncio
from typing import Any, Callable, Dict, List, Optional

from marie_tpu_torch.logging_core import MarieLogger
from marie_tpu_torch.types.docs import DocumentArray
from marie_tpu_torch.types.request import DataRequest


class BatchQueue:
    def __init__(
        self,
        func: Callable,  # async fn(docs, parameters) -> docs
        preferred_batch_size: int = 4,
        timeout: float = 10_000,
        flush_all: bool = False,
    ):
        self.func = func
        self.preferred_batch_size = preferred_batch_size
        self.timeout = timeout / 1000.0
        self.flush_all = flush_all
        self.logger = MarieLogger("BatchQueue")
        self._queue: List[Dict[str, Any]] = []  # {request, future}
        self._lock = asyncio.Lock()
        self._timer: Optional[asyncio.Task] = None
        self._num_docs = 0

    async def push(self, request: DataRequest) -> Any:
        """Enqueue; resolves when the batch containing this request ran."""
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        async with self._lock:
            self._queue.append({"request": request, "future": fut})
            self._num_docs += len(request.docs)
            if self._num_docs >= self.preferred_batch_size:
                self._schedule_flush(immediate=True)
            elif self._timer is None:
                self._timer = asyncio.create_task(self._timeout_flush())
        return await fut

    def _schedule_flush(self, immediate: bool = False) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        asyncio.create_task(self._flush())

    async def _timeout_flush(self) -> None:
        try:
            await asyncio.sleep(self.timeout)
            async with self._lock:
                self._timer = None
            await self._flush()
        except asyncio.CancelledError:
            pass

    async def _flush(self) -> None:
        async with self._lock:
            if not self._queue:
                return
            if self.flush_all:
                batch, self._queue = self._queue, []
                self._num_docs = 0
            else:
                take_docs = 0
                batch = []
                while self._queue and (
                    take_docs < self.preferred_batch_size or not batch
                ):
                    item = self._queue.pop(0)
                    batch.append(item)
                    take_docs += len(item["request"].docs)
                self._num_docs -= take_docs
                if self._queue and self._timer is None:
                    self._timer = asyncio.create_task(self._timeout_flush())

        merged = DocumentArray()
        counts = []
        for item in batch:
            docs = item["request"].docs
            counts.append(len(docs))
            merged.extend(docs)
        parameters = batch[0]["request"].parameters

        try:
            out = await self.func(docs=merged, parameters=parameters)
            result_docs = out if out is not None else merged
            # split results back per request, in order
            offset = 0
            for item, n in zip(batch, counts):
                sliced = DocumentArray(list(result_docs)[offset : offset + n])
                offset += n
                if not item["future"].done():
                    item["future"].set_result(sliced)
        except Exception as ex:  # noqa: BLE001 — propagate to every waiter
            for item in batch:
                if not item["future"].done():
                    item["future"].set_exception(ex)

    async def close(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
        await self._flush()
