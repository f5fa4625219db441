"""Service discovery (port of ``marie_tpu/serve/discovery/registry.py``): a
lease-based registry with prefix watches, as a small gRPC service
(``marie.Discovery``) on the port's transport
(:mod:`marie_tpu_torch.serve.networking.grpc_wire`).

Methods, each with a JSON body: ``put`` (``{"key", "value", "ttl"}``; a
``ttl`` gives the key a lease), ``delete``, ``get_prefix`` (the live keys
under a prefix), ``keepalive`` (renews a key's lease) and the streamed
``watch`` (``{"op": "put" | "delete" | "expire", "key", "value"}`` events
under a prefix).  The server reaps expired keys every second.  Workers
register under ``gateway/<deployment>/<name>``; a gateway watches the
prefix and rebuilds its routing.
"""

import asyncio
import json
import time
from typing import AsyncIterator, Callable, Dict, List, Optional, Tuple

from marie_tpu_torch.logging_core import MarieLogger
from marie_tpu_torch.serve.networking import grpc_wire
from marie_tpu_torch.serve.networking.grpc_wire import UNARY_STREAM, UNARY_UNARY, RpcError

_SVC = "marie.Discovery"
_PUT = f"/{_SVC}/put"
_DELETE = f"/{_SVC}/delete"
_GET_PREFIX = f"/{_SVC}/get_prefix"
_KEEPALIVE = f"/{_SVC}/keepalive"
_WATCH = f"/{_SVC}/watch"

DEFAULT_LEASE_TTL = 6.0


def _enc(obj) -> bytes:
    return json.dumps(obj).encode()


def _dec(raw: bytes):
    return json.loads(raw.decode()) if raw else None


class DiscoveryServer:
    """The registry's server (in a gateway's process or on its own);
    ``port`` 0 (the default) takes a free port at :meth:`start`."""

    def __init__(self, port: Optional[int] = None, host: str = "0.0.0.0"):
        self.port = port or 0
        self.host = host
        self.logger = MarieLogger("DiscoveryServer")
        # key -> (value, expiry time or None)
        self._store: Dict[str, Tuple[str, Optional[float]]] = {}
        self._watchers: List[asyncio.Queue] = []
        self._server: Optional[grpc_wire.Server] = None
        self._reaper: Optional[asyncio.Task] = None

    # --- the methods ------------------------------------------------------
    async def _put(self, raw: bytes, ctx) -> bytes:
        req = _dec(raw)
        ttl = req.get("ttl")
        self._store[req["key"]] = (req["value"], time.time() + ttl if ttl else None)
        await self._emit("put", req["key"], req["value"])
        return _enc({"ok": True})

    async def _delete(self, raw: bytes, ctx) -> bytes:
        req = _dec(raw)
        existed = self._store.pop(req["key"], None)
        if existed is not None:
            await self._emit("delete", req["key"], existed[0])
        return _enc({"ok": existed is not None})

    async def _get_prefix(self, raw: bytes, ctx) -> bytes:
        req = _dec(raw)
        now = time.time()
        return _enc({"items": {k: v for k, (v, exp) in self._store.items()
                               if k.startswith(req["prefix"]) and (exp is None or exp > now)}})

    async def _keepalive(self, raw: bytes, ctx) -> bytes:
        req = _dec(raw)
        item = self._store.get(req["key"])
        if item is None:
            return _enc({"ok": False})
        self._store[req["key"]] = (item[0], time.time() + req.get("ttl", DEFAULT_LEASE_TTL))
        return _enc({"ok": True})

    async def _watch(self, raw: bytes, ctx) -> AsyncIterator[bytes]:
        prefix = _dec(raw).get("prefix", "")
        queue: asyncio.Queue = asyncio.Queue()
        self._watchers.append(queue)
        try:
            while True:
                event = await queue.get()
                if event["key"].startswith(prefix):
                    yield _enc(event)
        finally:
            self._watchers.remove(queue)

    async def _emit(self, op: str, key: str, value: str) -> None:
        for q in self._watchers:
            q.put_nowait({"op": op, "key": key, "value": value})

    async def _reap_loop(self) -> None:
        while True:
            await asyncio.sleep(1.0)
            now = time.time()
            for k in [k for k, (_, exp) in self._store.items() if exp is not None and exp <= now]:
                value, _ = self._store.pop(k)
                await self._emit("expire", k, value)

    # --- lifecycle --------------------------------------------------------
    async def start(self) -> None:
        self._server = grpc_wire.Server()
        for path, kind, fn in ((_PUT, UNARY_UNARY, self._put),
                               (_DELETE, UNARY_UNARY, self._delete),
                               (_GET_PREFIX, UNARY_UNARY, self._get_prefix),
                               (_KEEPALIVE, UNARY_UNARY, self._keepalive),
                               (_WATCH, UNARY_STREAM, self._watch)):
            self._server.add_method(path, kind, fn)
        self.port = await self._server.start(self.host, self.port)
        self._reaper = asyncio.create_task(self._reap_loop())

    async def stop(self) -> None:
        """Stop reaping and serving; open watches end (CANCELLED)."""
        if self._reaper:
            self._reaper.cancel()
            await asyncio.gather(self._reaper, return_exceptions=True)
        if self._server:
            await self._server.stop(grace=0.5)

    @property
    def address(self) -> str:
        return f"127.0.0.1:{self.port}"


class DiscoveryClient:
    """The registry's client: a lease kept alive in the background
    (:meth:`register`) and watch callbacks."""

    def __init__(self, address: str):
        self.address = address
        self.logger = MarieLogger("DiscoveryClient")
        self._channel: Optional[grpc_wire.Channel] = None
        self._keepalive_tasks: Dict[str, asyncio.Task] = {}

    def _chan(self) -> grpc_wire.Channel:
        if self._channel is None:
            self._channel = grpc_wire.Channel(self.address)
        return self._channel

    async def _call(self, method: str, payload: dict) -> dict:
        return _dec(await self._chan().unary_unary(method, _enc(payload)))

    # --- the API ----------------------------------------------------------
    async def put(self, key: str, value: str, ttl: Optional[float] = None) -> None:
        await self._call(_PUT, {"key": key, "value": value, "ttl": ttl})

    async def delete(self, key: str) -> None:
        self._stop_keepalive(key)
        await self._call(_DELETE, {"key": key})

    async def get_prefix(self, prefix: str) -> Dict[str, str]:
        return (await self._call(_GET_PREFIX, {"prefix": prefix}))["items"]

    async def register(self, key: str, value: str, ttl: float = DEFAULT_LEASE_TTL) -> None:
        """PUT under a lease renewed every ``ttl / 3`` in the background."""
        await self.put(key, value, ttl=ttl)
        self._stop_keepalive(key)
        self._keepalive_tasks[key] = asyncio.create_task(self._keepalive_loop(key, ttl))

    def _stop_keepalive(self, key: str) -> None:
        task = self._keepalive_tasks.pop(key, None)
        if task:
            task.cancel()

    async def _keepalive_loop(self, key: str, ttl: float) -> None:
        try:
            while True:
                await asyncio.sleep(ttl / 3)
                resp = await self._call(_KEEPALIVE, {"key": key, "ttl": ttl})
                if not resp.get("ok"):
                    self.logger.warning(f"lease for {key} lost")
                    return
        except asyncio.CancelledError:
            pass
        except RpcError as ex:
            self.logger.warning(f"keepalive for {key} failed: {ex.code().name}")

    async def watch(self, prefix: str, callback: Callable[[dict], None]) -> asyncio.Task:
        """Stream watch events to ``callback``; the consuming task, which
        ends when the stream does (the server stopped)."""
        async def _consume():
            try:
                async for raw in self._chan().unary_stream(_WATCH, _enc({"prefix": prefix})):
                    try:
                        callback(_dec(raw))
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
