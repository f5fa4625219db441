"""GrpcConnectionPool (port of ``marie_tpu/serve/networking/connection_pool.py``):
the replicas of each deployment, balanced round robin (or by fewest calls
in flight), with retries that reset the failed replica's channel and move
on to the next one on UNAVAILABLE, DEADLINE_EXCEEDED and NOT_FOUND.  A
request carries the active trace context to the worker as W3C
``traceparent`` metadata.

A RAFT follower answers a write with "not the leader" (a ``NotTheLeader``
exception under ``executor="raft"``): the pool sends the request again,
with its status clear as the caller sent it, to the next replica, at most
``retries * len(replicas)`` attempts in all, backing off once every
replica has been tried (an election in progress).  Only that answer is
retried: a replicated write that failed on the leader (a timeout) may
have applied, and is answered as it stands.
"""

import asyncio
import itertools
from typing import Any, Dict, List, Optional, Sequence

from marie_tpu_torch.excepts import EstablishGrpcConnectionError, InternalNetworkError
from marie_tpu_torch.logging_core import MarieLogger
from marie_tpu_torch.proto import messages
from marie_tpu_torch.serve.instrumentation import tracing
from marie_tpu_torch.serve.networking.grpc_wire import MAX_MESSAGE, Channel, RpcError, StatusCode
from marie_tpu_torch.types.request import DataRequest, to_request_list_bytes

RETRYABLE_CODES = (StatusCode.UNAVAILABLE, StatusCode.DEADLINE_EXCEEDED, StatusCode.NOT_FOUND)

_PROCESS_DATA = "/jina.JinaDataRequestRPC/process_data"
_DISCOVER = "/jina.JinaDiscoverEndpointsRPC/endpoint_discovery"
_STREAM_DOC = "/jina.JinaSingleDocumentRequestRPC/stream_doc"


def _not_the_leader(resp: DataRequest) -> bool:
    """A RAFT follower's answer to a write."""
    if not resp.is_error():
        return False
    ex = resp.status.exception
    return ex.executor == "raft" and ex.name == "NotTheLeader"


class _Replica:
    def __init__(self, address: str):
        self.address = address
        self.channel: Optional[Channel] = None
        self.in_flight = 0

    def get_channel(self) -> Channel:
        if self.channel is None:
            self.channel = Channel(self.address, max_message=MAX_MESSAGE)
        return self.channel

    async def reset(self) -> None:
        if self.channel is not None:
            channel, self.channel = self.channel, None
            await channel.close()

    async def close(self) -> None:
        await self.reset()


class _ReplicaList:
    def __init__(self, balancer: str = "round_robin"):
        self.replicas: List[_Replica] = []
        self.balancer = balancer
        self._rr = itertools.count()

    def add(self, address: str) -> None:
        if address not in [r.address for r in self.replicas]:
            self.replicas.append(_Replica(address))

    def remove(self, address: str) -> None:
        self.replicas = [r for r in self.replicas if r.address != address]

    def pick(self) -> _Replica:
        if not self.replicas:
            raise EstablishGrpcConnectionError("no replicas available")
        if self.balancer == "least_connection":
            return min(self.replicas, key=lambda r: r.in_flight)
        return self.replicas[next(self._rr) % len(self.replicas)]

    async def close(self) -> None:
        for r in self.replicas:
            await r.close()


class GrpcConnectionPool:
    def __init__(self, balancer: str = "round_robin", retries: int = 3):
        self.logger = MarieLogger("GrpcConnectionPool")
        self.balancer = balancer
        self.retries = retries
        self._deployments: Dict[str, _ReplicaList] = {}

    # --- topology ---------------------------------------------------------
    def add_connection(self, deployment: str, address: str) -> None:
        self._deployments.setdefault(deployment, _ReplicaList(self.balancer)).add(address)

    def remove_connection(self, deployment: str, address: str) -> None:
        if deployment in self._deployments:
            self._deployments[deployment].remove(address)

    def deployments(self) -> List[str]:
        return list(self._deployments)

    def addresses(self, deployment: str) -> List[str]:
        rl = self._deployments.get(deployment)
        return [r.address for r in rl.replicas] if rl else []

    def _replicas(self, deployment: str) -> _ReplicaList:
        rl = self._deployments.get(deployment)
        if rl is None or not rl.replicas:
            raise EstablishGrpcConnectionError(f"no connections for deployment {deployment!r}")
        return rl

    # --- sending ----------------------------------------------------------
    async def send_requests_once(self, requests: Sequence[DataRequest], deployment: str,
                                 timeout: Optional[float] = None,
                                 endpoint: Optional[str] = None) -> DataRequest:
        """Send to one replica of a deployment, with retries and failover."""
        rl = self._replicas(deployment)
        req = requests[0]
        if endpoint:
            req.exec_endpoint = endpoint
        payload = to_request_list_bytes([req])
        last_error: Optional[BaseException] = None
        attempts = max(self.retries, self.retries * len(rl.replicas))
        for attempt in range(attempts):
            replica = rl.pick()
            replica.in_flight += 1
            try:
                # the active trace context goes on as the call's traceparent
                raw = await replica.get_channel().unary_unary(
                    _PROCESS_DATA, payload, timeout=timeout,
                    metadata=tracing.inject_metadata(None) or None)
                resp = DataRequest.from_bytes(raw)
                if _not_the_leader(resp) and attempt + 1 < attempts:
                    # the original payload goes again: the status clear
                    self.logger.debug(f"{deployment}@{replica.address} is not the raft "
                                      "leader; retrying the next replica")
                    if attempt + 1 >= len(rl.replicas):
                        await asyncio.sleep(min(0.05 * (2 ** (attempt // len(rl.replicas))),
                                                1.0))
                    continue
                return resp
            except RpcError as ex:
                last_error = ex
                if ex.code() not in RETRYABLE_CODES:
                    raise InternalNetworkError(ex, request_id=req.request_id,
                                               details=ex.details())
                self.logger.warning(f"{deployment}@{replica.address} failed with "
                                    f"{ex.code().name}; retry {attempt + 1}/{self.retries}")
                await replica.reset()
                await asyncio.sleep(min(0.05 * (2 ** attempt), 1.0))
            finally:
                replica.in_flight -= 1
        raise InternalNetworkError(last_error, request_id=req.request_id,
                                   details=f"exhausted {self.retries} retries for {deployment}")

    async def stream_single_doc(self, request: Dict[str, Any], deployment: str,
                                timeout: Optional[float] = None):
        """Proxy one ``stream_doc`` call (a ``SingleDocumentRequestProto``,
        dict form) to a replica, yielding the responses as the worker
        sends them.  A failure before the first fails over; after it the
        stream is committed (a generator endpoint run again could repeat
        its side effects)."""
        rl = self._replicas(deployment)
        payload = messages.encode("jina.SingleDocumentRequestProto", request)
        request_id = request.get("header", {}).get("request_id", "")
        last_error: Optional[BaseException] = None
        for attempt in range(max(self.retries, 1)):
            replica = rl.pick()
            replica.in_flight += 1
            started = False
            try:
                async for raw in replica.get_channel().unary_stream(_STREAM_DOC, payload,
                                                                    timeout=timeout):
                    started = True
                    yield messages.decode("jina.SingleDocumentRequestProto", raw)
                return
            except RpcError as ex:
                last_error = ex
                if started or ex.code() not in RETRYABLE_CODES:
                    raise InternalNetworkError(ex, request_id=request_id, details=ex.details())
                self.logger.warning(f"stream_doc to {deployment}@{replica.address} failed "
                                    f"with {ex.code().name}; retry {attempt + 1}/{self.retries}")
                await replica.reset()
                await asyncio.sleep(min(0.05 * (2 ** attempt), 1.0))
            finally:
                replica.in_flight -= 1
        raise InternalNetworkError(last_error, request_id=request_id,
                                   details=f"exhausted {self.retries} retries for {deployment}")

    async def send_discover_endpoint(self, deployment: str,
                                     timeout: Optional[float] = 5.0) -> dict:
        replica = self._replicas(deployment).pick()
        raw = await replica.get_channel().unary_unary(_DISCOVER, b"", timeout=timeout)
        proto = messages.decode("jina.EndpointsProto", raw)
        return {"endpoints": list(proto.get("endpoints", [])),
                "write_endpoints": list(proto.get("write_endpoints", [])),
                "schemas": messages.struct_to_py(proto.get("schemas", {}))}

    async def close(self) -> None:
        for rl in self._deployments.values():
            await rl.close()
        self._deployments.clear()
