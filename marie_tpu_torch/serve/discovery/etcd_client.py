"""etcd v3 client (port of ``marie_tpu/serve/discovery/etcd_client.py``) on
the real ``etcdserverpb`` gRPC API, with no etcd3 library and no codegen:
messages are written with the port's protobuf codec
(:mod:`marie_tpu_torch.proto.wire`, ``{field: value}`` dicts) against the
field numbers of etcd's ``rpc.proto`` and ``kv.proto``, and go over the
port's gRPC :class:`Channel`.

KV ``Range`` / ``Put`` / ``DeleteRange``, ``LeaseGrant``, the
``LeaseKeepAlive`` stream (a keepalive every third of the TTL) and the
``Watch`` stream, whose events take the :class:`DiscoveryClient` dict
shape (``{"op": "put" | "delete", "key", "value"}``).  Its surface is
the DiscoveryClient's, so a gateway's discovery can point at etcd by
swapping the client class.
"""

import asyncio
from typing import Callable, Dict, Optional

from marie_tpu_torch.logging_core import MarieLogger
from marie_tpu_torch.proto import wire
from marie_tpu_torch.serve.networking.grpc_wire import Channel, RpcError

_KV_RANGE = "/etcdserverpb.KV/Range"
_KV_PUT = "/etcdserverpb.KV/Put"
_KV_DELETE = "/etcdserverpb.KV/DeleteRange"
_LEASE_GRANT = "/etcdserverpb.Lease/LeaseGrant"
_LEASE_KEEPALIVE = "/etcdserverpb.Lease/LeaseKeepAlive"
_WATCH = "/etcdserverpb.Watch/Watch"

DEFAULT_LEASE_TTL = 6


def prefix_range_end(prefix: bytes) -> bytes:
    """etcd's prefix query: range_end is the prefix with its last byte
    below 0xff raised by one."""
    end = bytearray(prefix)
    for i in reversed(range(len(end))):
        if end[i] < 0xFF:
            end[i] += 1
            return bytes(end[: i + 1])
    return b"\x00"


class EtcdClient:
    """Async etcd v3 client over the gRPC API."""

    def __init__(self, address: str = "127.0.0.1:2379"):
        self.address = address
        self.logger = MarieLogger("EtcdClient")
        self._channel: Optional[Channel] = None
        self._keepalive_tasks: Dict[str, asyncio.Task] = {}
        self._leases: Dict[str, int] = {}

    def _chan(self) -> Channel:
        if self._channel is None:
            self._channel = Channel(self.address)
        return self._channel

    async def _unary(self, method: str, msg: wire.Msg) -> Dict:
        return wire.decode(await self._chan().unary_unary(method, wire.encode(msg)))

    # --- KV ---------------------------------------------------------------
    async def put(self, key: str, value: str, ttl: Optional[float] = None) -> None:
        """PutRequest{key=1, value=2, lease=3}."""
        lease_id = 0
        if ttl:
            lease_id = await self._grant_lease(int(ttl))
            self._leases[key] = lease_id
        await self._unary(_KV_PUT, {1: key.encode(), 2: value.encode(), 3: lease_id})

    async def delete(self, key: str) -> None:
        self._stop_keepalive(key)
        await self._unary(_KV_DELETE, {1: key.encode()})

    async def get_prefix(self, prefix: str) -> Dict[str, str]:
        """RangeRequest{key=1, range_end=2} -> RangeResponse{kvs=2}."""
        resp = await self._unary(_KV_RANGE, {1: prefix.encode(),
                                             2: prefix_range_end(prefix.encode())})
        out: Dict[str, str] = {}
        for raw in resp.get(2, []):  # repeated mvccpb.KeyValue{key=1, value=5}
            kv = wire.decode(raw)
            out[wire.first(kv, 1, b"").decode()] = wire.first(kv, 5, b"").decode()
        return out

    # --- leases -----------------------------------------------------------
    async def _grant_lease(self, ttl: int) -> int:
        """LeaseGrantRequest{TTL=1} -> LeaseGrantResponse{ID=2}."""
        return int(wire.first(await self._unary(_LEASE_GRANT, {1: ttl}), 2, 0))

    async def register(self, key: str, value: str, ttl: float = DEFAULT_LEASE_TTL) -> None:
        """PUT under a lease refreshed in the background."""
        await self.put(key, value, ttl=max(int(ttl), 1))
        self._stop_keepalive(key)
        self._keepalive_tasks[key] = asyncio.create_task(
            self._keepalive_loop(key, max(ttl, 1.0)))

    def _stop_keepalive(self, key: str) -> None:
        task = self._keepalive_tasks.pop(key, None)
        if task:
            task.cancel()

    async def _keepalive_loop(self, key: str, ttl: float) -> None:
        """LeaseKeepAlive stream: {ID=1} every ttl/3; an answer with TTL=3
        at 0 means the lease is gone."""
        lease_id = self._leases.get(key, 0)
        if not lease_id:
            return

        async def requests():
            while True:
                yield wire.encode({1: lease_id})
                await asyncio.sleep(ttl / 3)

        try:
            async for raw in self._chan().stream_stream(_LEASE_KEEPALIVE, requests()):
                if int(wire.first(wire.decode(raw), 3, 0)) <= 0:
                    self.logger.warning(f"lease for {key} expired")
                    return
        except asyncio.CancelledError:
            pass
        except RpcError as ex:
            self.logger.warning(f"keepalive for {key} failed: {ex.code().name}")

    # --- watch ------------------------------------------------------------
    async def watch(self, prefix: str, callback: Callable[[dict], None]) -> asyncio.Task:
        """The Watch stream over the prefix; each event to ``callback`` as
        ``{"op": "put" | "delete", "key", "value"}``; the consuming task."""
        create = wire.encode({1: {1: prefix.encode(),  # WatchCreateRequest
                                  2: prefix_range_end(prefix.encode())}})

        async def requests():
            yield create
            while True:  # the stream stays open
                await asyncio.sleep(3600)

        async def _consume():
            try:
                async for raw in self._chan().stream_stream(_WATCH, requests()):
                    for ev_raw in wire.decode(raw).get(11, []):  # repeated mvccpb.Event
                        ev = wire.decode(ev_raw)
                        kv = wire.decode(wire.first(ev, 2, b""))
                        event = {"op": "put" if int(wire.first(ev, 1, 0)) == 0 else "delete",
                                 "key": wire.first(kv, 1, b"").decode(),
                                 "value": wire.first(kv, 5, b"").decode()}
                        try:
                            callback(event)
                        except Exception as ex:  # noqa: BLE001
                            self.logger.error(f"watch callback failed: {ex!r}")
            except RpcError as ex:
                self.logger.debug(f"watch of {prefix!r} ended: {ex.code().name}")

        return asyncio.create_task(_consume())

    async def close(self) -> None:
        for key in list(self._keepalive_tasks):
            self._stop_keepalive(key)
        if self._channel is not None:
            await self._channel.close()
