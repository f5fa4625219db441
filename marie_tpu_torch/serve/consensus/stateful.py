"""Stateful replicated executors over RAFT (port of
``marie_tpu/serve/consensus/stateful.py``).

Writes go through the leader's log; every replica's FSM applies the
committed requests to its local executor, in log order, so all replicas
reach the same state.  A follower answers "not the leader" (an exception
whose ``executor`` is ``"raft"``) and the connection pool retries the
next replica.  The FSM runs the request through the worker's own
handler, so the model work of a replicated request goes where an
unreplicated one's goes: the OCR engine's page programs run on the
process's kept device thread (``ocr/fused.py::_DeviceThread``).
"""

import asyncio
import threading
from typing import Any, Dict

from marie_tpu_torch.logging_core import MarieLogger
from marie_tpu_torch.serve.consensus import RaftNode
from marie_tpu_torch.types.request import DataRequest

#: a write's wait for its local application, and the FSM's for the executor
WRITE_TIMEOUT_S = 30.0
APPLY_TIMEOUT_S = 60.0


class NotTheLeader(Exception):
    def __init__(self, leader_id: str = ""):
        self.leader_id = leader_id
        super().__init__(f"not the leader (leader={leader_id or 'unknown'})")


class StatefulExecutorAdapter:
    """A :class:`WorkerRequestHandler` with RAFT-replicated writes.

    :meth:`process_write` submits the serialized request to the log and
    waits for its local application; committed entries are applied to the
    executor on every replica (in log order, one at a time)."""

    def __init__(self, handler, node_id: str, bind_addr: str):
        self.logger = MarieLogger(f"stateful/{node_id}")
        self.handler = handler
        self._applied_index = 0
        self._apply_events: Dict[int, threading.Event] = {}
        self._results: Dict[int, Any] = {}
        self._lock = threading.Lock()
        self._loop = asyncio.new_event_loop()
        self._loop_thread = threading.Thread(target=self._loop.run_forever, daemon=True)
        self._loop_thread.start()
        self.node = RaftNode(node_id, bind_addr, apply_fn=self._apply)

    # --- FSM --------------------------------------------------------------
    def _apply(self, data: bytes, index: int) -> None:
        """A committed entry, executed on the local executor (in order)."""
        req = DataRequest.from_bytes(data)
        fut = asyncio.run_coroutine_threadsafe(self.handler.process_data([req]), self._loop)
        result = fut.result(timeout=APPLY_TIMEOUT_S)
        with self._lock:
            self._applied_index = index
            self._results[index] = result
            # a bounded stash: never drop an index a writer still awaits (its
            # event stays registered until it collects), with a hard cap so
            # that a follower (no writers) stays bounded too
            min_awaited = min(self._apply_events) if self._apply_events else index + 1
            for old in sorted(self._results):
                if len(self._results) <= 64 or old >= min_awaited:
                    break
                self._results.pop(old)
            while len(self._results) > 1024:
                self._results.pop(min(self._results))
            ev = self._apply_events.get(index)
        if ev is not None:
            ev.set()

    @property
    def applied_index(self) -> int:
        with self._lock:
            return self._applied_index

    def take_result(self, index: int):
        with self._lock:
            return self._results.pop(index, None)

    # --- write path -------------------------------------------------------
    def process_write(self, request: DataRequest, timeout: float = WRITE_TIMEOUT_S):
        """Replicate and apply a write: (index, the local result).  Raises
        :class:`NotTheLeader` on a follower, and RuntimeError when the
        entry applied but its result is gone (never silent)."""
        idx = self.node.submit(request.to_bytes())
        if idx == 0:
            raise NotTheLeader(self.node.leader_id)
        ev = threading.Event()
        with self._lock:
            if idx in self._results:
                return idx, self._results.pop(idx)
            self._apply_events[idx] = ev
        try:
            if not ev.wait(timeout):
                raise TimeoutError(f"entry {idx} not applied within {timeout}s")
            result = self.take_result(idx)
            if result is None:
                raise RuntimeError(f"entry {idx} applied but its result was dropped")
            return idx, result
        finally:
            with self._lock:
                self._apply_events.pop(idx, None)

    # --- lifecycle --------------------------------------------------------
    def start(self) -> "StatefulExecutorAdapter":
        self.node.start()
        return self

    def add_voter(self, node_id: str, addr: str) -> None:
        self.node.add_voter(node_id, addr)

    @property
    def is_leader(self) -> bool:
        return self.node.is_leader

    def shutdown(self) -> None:
        self.node.shutdown()
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._loop_thread.join(timeout=5)


class StatefulReplicatedHandler:
    """The request handler of a RAFT-replicated worker pod.

    Only ``@write`` endpoints replicate when the executor declares some
    (reads run locally on any replica); an executor that declares none
    replicates every request.  A follower answers with the request and a
    :class:`NotTheLeader` exception under ``executor="raft"``, so the pool
    retries the next replica.  Discovery and info pass through, with
    ``info()["raft"]`` the node's configuration and, beside it, its
    ``commit_index`` and ``applied_index``."""

    def __init__(self, handler, node_id: str, bind_addr: str, peers=None):
        self.inner = handler
        self.name = getattr(handler, "name", node_id)
        self.logger = MarieLogger(f"stateful-handler/{node_id}")
        self.adapter = StatefulExecutorAdapter(handler, node_id, bind_addr)
        for peer_id, addr in peers or []:
            self.adapter.add_voter(peer_id, addr)
        self.adapter.start()

    async def process_data(self, requests):
        req = requests[0]
        writes = set(self.inner.executor.write_endpoints)
        if writes and req.exec_endpoint not in writes:
            return await self.inner.process_data(requests)
        try:
            loop = asyncio.get_running_loop()
            # the leader's FSM applied the request too: its local result
            _, result = await loop.run_in_executor(None, lambda: self.adapter.process_write(req))
            return result
        except NotTheLeader as ex:
            req.add_exception(ex, executor="raft")
            return req
        except (TimeoutError, RuntimeError) as ex:
            self.logger.error(f"replicated write failed: {ex!r}")
            req.add_exception(ex, executor="raft")
            return req

    def record_response_bytes(self, nbytes: int) -> None:
        self.inner.record_response_bytes(nbytes)

    def endpoints(self):
        return self.inner.endpoints()

    def info(self):
        info = self.inner.info()
        node = self.adapter.node
        info["raft"] = {**node.get_configuration(), "commit_index": node.commit_index,
                        "applied_index": self.adapter.applied_index}
        return info

    def snapshot(self, snapshot_file: str) -> None:
        self.inner.snapshot(snapshot_file)

    def restore(self, snapshot_file: str) -> None:
        self.inner.restore(snapshot_file)

    async def close(self) -> None:
        self.adapter.shutdown()
        await self.inner.close()
