"""The port's discovery (``serve/discovery/``) against the JAX package's.

The port's ``DiscoveryClient`` drives the JAX ``DiscoveryServer``
(grpcio) and the JAX client the port's server (the standard library's
HTTP/2): put / get / delete, lease expiry with short TTLs, a keepalive
that holds a lease, and watch events (the cases of
``tests/integration/test_discovery.py``).  The port's ``EtcdClient``
runs the cases of ``tests/integration/test_etcd_client.py`` against its
``FakeEtcd`` (etcd v3's wire on grpcio), beside the JAX client.  Then,
in port form, ``tests/integration/test_elasticity.py``'s gateway rebuilt
from discovery and a spawned worker pod that registers and deregisters
on a graceful close."""

import asyncio
import json
import socket
import time

import pytest

from marie_tpu.serve.discovery import DiscoveryClient as JDiscoveryClient
from marie_tpu.serve.discovery import DiscoveryServer as JDiscoveryServer
from marie_tpu.serve.discovery.etcd_client import EtcdClient as JEtcdClient
from marie_tpu.serve.discovery.etcd_client import prefix_range_end as jprefix_range_end
from marie_tpu_torch.serve.discovery import DiscoveryClient, DiscoveryServer, EtcdClient
from marie_tpu_torch.serve.discovery.etcd_client import prefix_range_end
from marie_tpu_torch.serve.discovery.registry import DEFAULT_LEASE_TTL
from marie_tpu_torch.serve.executors import BaseExecutor
from marie_tpu_torch.serve.executors.decorators import requests
from tests.integration.test_etcd_client import FakeEtcd

#: (client, server) of the two packages, each way
PAIRS = [("port", "jax"), ("jax", "port")]
SIDES = {"port": (DiscoveryClient, DiscoveryServer), "jax": (JDiscoveryClient, JDiscoveryServer)}


async def _pair(client_side, server_side):
    server = SIDES[server_side][1]()
    await server.start()
    return server, SIDES[client_side][0](server.address)


def test_put_get_delete_and_watch_both_ways():
    """Each package's client against the other's server: the prefix's
    items, a delete, and the watch's events under its prefix only."""
    async def run(client_side, server_side):
        server, client = await _pair(client_side, server_side)
        try:
            events = []
            task = await client.watch("gateway/", events.append)
            await asyncio.sleep(0.2)  # the watch attaches
            await client.put("gateway/worker-1", "127.0.0.1:1234")
            await client.put("gateway/worker-2", "127.0.0.1:5678")
            await client.put("other/x", "y")
            first = await client.get_prefix("gateway/")
            await client.delete("gateway/worker-1")
            second = await client.get_prefix("gateway/")
            await asyncio.sleep(0.3)
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)
            await client.close()
            return first, list(second), events
        finally:
            await server.stop()

    want = ({"gateway/worker-1": "127.0.0.1:1234", "gateway/worker-2": "127.0.0.1:5678"},
            ["gateway/worker-2"],
            [{"op": "put", "key": "gateway/worker-1", "value": "127.0.0.1:1234"},
             {"op": "put", "key": "gateway/worker-2", "value": "127.0.0.1:5678"},
             {"op": "delete", "key": "gateway/worker-1", "value": "127.0.0.1:1234"}])
    for pair in PAIRS + [("port", "port")]:
        assert asyncio.run(run(*pair)) == want, pair


def test_leases_expire_and_keepalives_hold_them_both_ways():
    """A put with a 1.2 s TTL expires (the reaper's ``expire`` event); a
    registered key outlives its TTL while its keepalive runs and expires
    once the client is closed; the pairs run at once."""
    async def run(client_side, server_side):
        server, client = await _pair(client_side, server_side)
        watcher = SIDES[client_side][0](server.address)
        try:
            events = []
            task = await watcher.watch("gateway/", events.append)
            await asyncio.sleep(0.2)
            await client.put("gateway/mortal", "addr", ttl=1.2)
            await client.register("gateway/alive", "addr", ttl=1.0)
            had = sorted(await client.get_prefix("gateway/"))
            await asyncio.sleep(2.5)  # the reaper runs every second
            held = sorted(await client.get_prefix("gateway/"))
            await client.close()  # the keepalive stops
            await asyncio.sleep(2.5)
            probe = SIDES[client_side][0](server.address)
            left = await probe.get_prefix("gateway/")
            await probe.close()
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)
            await watcher.close()
            return had, held, left, [(e["op"], e["key"]) for e in events]
        finally:
            await server.stop()

    async def both():
        return await asyncio.gather(*(run(*pair) for pair in PAIRS))

    for got in asyncio.run(both()):
        assert got == (["gateway/alive", "gateway/mortal"], ["gateway/alive"], {},
                       [("put", "gateway/mortal"), ("put", "gateway/alive"),
                        ("expire", "gateway/mortal"), ("expire", "gateway/alive")])
    assert DEFAULT_LEASE_TTL == 6.0


def test_watch_ends_when_the_server_stops():
    """A watch on the port's server ends (CANCELLED) when the server stops,
    leaving no task behind; a keepalive against a stopped server ends."""
    async def run():
        server = DiscoveryServer()
        await server.start()
        client = DiscoveryClient(server.address)
        task = await client.watch("gateway/", lambda e: None)
        await client.register("gateway/k", "v", ttl=0.6)
        await asyncio.sleep(0.2)
        await server.stop()
        await asyncio.wait_for(task, 5)
        keepalive = client._keepalive_tasks["gateway/k"]
        await asyncio.wait_for(keepalive, 5)
        await client.close()
        return task.exception(), [t for t in asyncio.all_tasks() if t is not asyncio.current_task()]

    assert asyncio.run(run()) == (None, [])


# --- etcd v3 ----------------------------------------------------------------
def test_etcd_prefix_range_end():
    for prefix in (b"gateway/", b"a\xff", b"\xff\xff", b""):
        assert prefix_range_end(prefix) == jprefix_range_end(prefix)
    assert prefix_range_end(b"gateway/") == b"gateway0"


@pytest.mark.parametrize("cls", [EtcdClient, JEtcdClient], ids=["port", "jax"])
def test_etcd_client_cases_against_fake_etcd(cls):
    """The cases of ``tests/integration/test_etcd_client.py`` (KV and
    prefix; lease expiry and keepalive; watch events) on one FakeEtcd."""
    async def run():
        fake = FakeEtcd()
        await fake.start()
        client = cls(f"127.0.0.1:{fake.port}")
        try:
            await client.put("gateway/extract/rep-0", '{"address": "h:1"}')
            await client.put("gateway/extract/rep-1", '{"address": "h:2"}')
            await client.put("other/key", "x")
            kv = [await client.get_prefix("gateway/")]
            await client.delete("gateway/extract/rep-0")
            kv.append(list(await client.get_prefix("gateway/")))
            await client.delete("gateway/extract/rep-1")
            await client.register("gateway/w/0", "alive", ttl=1)
            await client.put("gateway/w/1", "dies", ttl=1)
            await asyncio.sleep(1.6)
            leases = await client.get_prefix("gateway/")
            events = []
            task = await client.watch("gateway/", events.append)
            await asyncio.sleep(0.2)
            await client.put("gateway/extract/rep-0", "v1")
            await client.put("unwatched/key", "v")
            await client.delete("gateway/extract/rep-0")
            await asyncio.sleep(0.3)
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)
            return kv, leases, events
        finally:
            await client.close()
            await fake.stop()

    kv, leases, events = asyncio.run(run())
    assert kv == [{"gateway/extract/rep-0": '{"address": "h:1"}',
                   "gateway/extract/rep-1": '{"address": "h:2"}'}, ["gateway/extract/rep-1"]]
    assert leases == {"gateway/w/0": "alive"}
    assert events == [{"op": "put", "key": "gateway/extract/rep-0", "value": "v1"},
                      {"op": "delete", "key": "gateway/extract/rep-0", "value": "v1"}]


def test_etcd_client_requests_are_the_jax_clients_bytes():
    """The port's client sends FakeEtcd the JAX client's request bytes."""
    async def run(cls):
        seen = []
        fake = FakeEtcd()
        for name in ("_kv_put", "_kv_range", "_kv_delete", "_lease_grant"):
            inner = getattr(fake, name)

            async def spy(raw, ctx, inner=inner, name=name):
                seen.append((name, bytes(raw)))
                return await inner(raw, ctx)

            setattr(fake, name, spy)
        await fake.start()
        client = cls(f"127.0.0.1:{fake.port}")
        try:
            await client.put("gateway/a", "1", ttl=3)
            await client.get_prefix("gateway/")
            await client.delete("gateway/a")
        finally:
            await client.close()
            await fake.stop()
        return seen

    port = asyncio.run(run(EtcdClient))
    assert port == asyncio.run(run(JEtcdClient))
    assert [name for name, _ in port] == ["_lease_grant", "_kv_put", "_kv_range", "_kv_delete"]


# --- the gateway and the pods (test_elasticity.py, in port form) ------------
class Upper(BaseExecutor):
    @requests
    def upper(self, docs, **kwargs):
        for d in docs:
            d.text = (d.text or "").upper()
        return docs


def test_gateway_elasticity_via_discovery():
    """A gateway with no static graph takes its workers from the registry:
    the first worker, a second that joins, the first's key deleted; the
    traffic follows, and an empty prefix keeps the last topology."""
    from marie_tpu_torch.serve.runtimes.gateway.request_handling import GatewayRequestHandler
    from marie_tpu_torch.serve.runtimes.servers import GRPCServer
    from marie_tpu_torch.serve.runtimes.worker.request_handling import WorkerRequestHandler
    from marie_tpu_torch.types.docs import Document, DocumentArray
    from marie_tpu_torch.types.request import DataRequest

    async def run():
        disc = DiscoveryServer()
        await disc.start()
        workers = []
        for _ in range(2):
            w = GRPCServer(WorkerRequestHandler(executor=Upper(), name="workers"), name="w")
            await w.setup_server()
            workers.append(w)
        w1, w2 = workers
        client = DiscoveryClient(disc.address)
        gw = GatewayRequestHandler({"start-gateway": []}, {})
        try:
            await client.register("gateway/workers/r1", json.dumps({"address": w1.address}),
                                  ttl=2.0)
            await gw.start_discovery(disc.address)
            pool = gw.streamer.connection_pool
            out = [(await gw.process_data([DataRequest.from_docs(
                DocumentArray([Document(text="a")]), endpoint="/default")])).docs.texts]
            await client.register("gateway/workers/r2", json.dumps({"address": w2.address}),
                                  ttl=2.0)
            await asyncio.sleep(0.5)
            out.append(sorted(pool.addresses("workers")) == sorted([w1.address, w2.address]))
            await client.delete("gateway/workers/r1")
            await asyncio.sleep(0.5)
            out.append(pool.addresses("workers") == [w2.address])
            out.append((await gw.process_data([DataRequest.from_docs(
                DocumentArray([Document(text="b")]), "/default")])).docs.texts)
            await client.delete("gateway/workers/r2")
            await asyncio.sleep(0.5)
            out.append(pool.addresses("workers") == [w2.address])
            return out
        finally:
            await gw.stop_discovery()
            await gw.close()
            await client.close()
            for w in workers:
                await w.shutdown()
            await disc.stop()

    assert asyncio.run(run()) == [["A"], True, True, ["B"], True]


def test_pod_registers_and_deregisters_on_graceful_close():
    """A spawned worker pod with ``discovery_address`` registers
    ``gateway/<deployment>/<name>`` with its address before readiness and
    deletes it at once on a graceful close; its port is free after."""
    from marie_tpu_torch.orchestrate.pods import Pod

    async def run():
        disc = DiscoveryServer()
        await disc.start()
        client = DiscoveryClient(disc.address)
        pod = Pod("worker", uses="marie_tpu_torch.executor.TextExtractionExecutorMock",
                  name="r1", deployment="dereg", discovery_address=disc.address)
        try:
            await asyncio.to_thread(pod.start)
            keys = await client.get_prefix("gateway/dereg/")
            t = time.perf_counter()
            await asyncio.to_thread(pod.close)
            while time.perf_counter() - t < 3.0:
                after = await client.get_prefix("gateway/dereg/")
                if "gateway/dereg/r1" not in after:
                    break
                await asyncio.sleep(0.1)
            return keys, after, pod.port, pod.exitcode
        finally:
            pod.close()
            await client.close()
            await disc.stop()

    keys, after, port, exitcode = asyncio.run(run())
    assert keys == {"gateway/dereg/r1": json.dumps({"address": f"127.0.0.1:{port}"})}
    assert after == {} and exitcode is not None
    with socket.socket() as s:
        s.bind(("127.0.0.1", port))
