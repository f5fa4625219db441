"""The port's gateway, head, connection pool, Deployment and Flow against
the JAX package's on the same graphs.

Each topology is a ``Flow`` of light executors (one class body, built on
each package's ``BaseExecutor``).  Most run in this process: every worker,
head and gateway of a flow is a ``GRPCServer`` of its package on one loop
thread, wired as ``Flow.start`` wires its pods (the same graph, addresses,
floating nodes and conditions), so the graph logic runs over real gRPC
without spawning.  Covered: chains, branches joined by ``needs_all``,
``when`` conditions, floating deployments, ``target_executor`` and
endpoint filtering, shards with polling ALL / ANY / per endpoint, and
replicas.  Two tests spawn pods of the port: a Flow with a sharded
deployment (gateway -> head -> workers), held to the JAX package's
handlers on the same graph, and a Deployment of replicas; their pods exit
on close and free their ports.  The module imports the JAX package only
inside its tests, so that a spawned pod importing the port's executor
from here stays light."""

import asyncio
import json
import socket
import threading

import pytest

from marie_tpu_torch.clients import GRPCClient
from marie_tpu_torch.enums import PollingType
from marie_tpu_torch.excepts import FlowMissingDeploymentError, FlowTopologyError
from marie_tpu_torch.orchestrate.deployments import Deployment
from marie_tpu_torch.orchestrate.flow import Flow
from marie_tpu_torch.serve.executors import BaseExecutor
from marie_tpu_torch.serve.executors import decorators as tdec
from marie_tpu_torch.serve.runtimes.gateway.conditions import doc_matches
from marie_tpu_torch.serve.runtimes.gateway.request_handling import GatewayRequestHandler
from marie_tpu_torch.serve.runtimes.head.request_handling import HeaderRequestHandler
from marie_tpu_torch.serve.runtimes.servers.grpc_server import GRPCServer
from marie_tpu_torch.serve.runtimes.worker.request_handling import WorkerRequestHandler
from marie_tpu_torch.types.docs import Document


class _Loop:
    """An asyncio loop on a thread, and the servers started on it (as in
    ``tests/test_torch_serve.py``, which imports the JAX package)."""

    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        self.servers = []

    def call(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(60)

    def serve(self, server):
        self.call(server.setup_server())
        self.servers.append(server)
        return server

    def close(self):
        for s in self.servers:
            self.call(s.shutdown())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)
        assert not self.thread.is_alive()
        self.loop.close()


def _named(cls, name):
    """Name a class built in a function after the module global it is
    bound to, so that a spawned pod can import it."""
    cls.__name__ = cls.__qualname__ = name
    return cls


def _tagger_class(base, dec):
    class Tagger(base):
        """Appends its name to each doc's ``seen`` tag; records its calls."""

        calls: list = []

        @dec.requests(on=["/", "/tag"])
        def tag(self, docs, parameters, **kwargs):
            for d in docs:
                d.tags["seen"] = list(d.tags.get("seen", [])) + [self.runtime_args.name]
            type(self).calls.append(self.runtime_args.name)
            return docs

        @dec.requests(on="/fail")
        def fail(self, docs, **kwargs):
            raise ValueError("failed on purpose")

    return Tagger


def _other_class(base, dec):
    class OnlyOther(base):
        """Serves ``/other`` only: the gateway skips it for other endpoints."""

        @dec.requests(on="/other")
        def other(self, docs, **kwargs):
            for d in docs:
                d.tags["other"] = True
            return docs

    return OnlyOther


TTagger = _named(_tagger_class(BaseExecutor, tdec), "TTagger")
TOther = _named(_other_class(BaseExecutor, tdec), "TOther")
SIDES = {
    "port": dict(flow=Flow, worker=WorkerRequestHandler, head=HeaderRequestHandler,
                 gateway=GatewayRequestHandler, server=GRPCServer, client=GRPCClient,
                 doc=Document, polling=PollingType, tagger=TTagger, other=TOther),
}


@pytest.fixture(scope="module", autouse=True)
def jax_side():
    """The JAX package's side of SIDES (imported here, not at module level)."""
    from marie_tpu.clients.grpc_client import GRPCClient as JGRPCClient
    from marie_tpu.enums import PollingType as JPollingType
    from marie_tpu.orchestrate.flow import Flow as JFlow
    from marie_tpu.serve.executors import BaseExecutor as JBaseExecutor
    from marie_tpu.serve.executors import decorators as jdec
    from marie_tpu.serve.runtimes.gateway.request_handling import GatewayRequestHandler as JGate
    from marie_tpu.serve.runtimes.head.request_handling import HeaderRequestHandler as JHead
    from marie_tpu.serve.runtimes.servers.grpc_server import GRPCServer as JGRPCServer
    from marie_tpu.serve.runtimes.worker.request_handling import (
        WorkerRequestHandler as JWorker)
    from marie_tpu.types.docs import Document as JDocument

    SIDES["jax"] = dict(flow=JFlow, worker=JWorker, head=JHead, gateway=JGate,
                        server=JGRPCServer, client=JGRPCClient, doc=JDocument,
                        polling=JPollingType, tagger=_tagger_class(JBaseExecutor, jdec),
                        other=_other_class(JBaseExecutor, jdec))
    yield SIDES["jax"]


@pytest.fixture(scope="module")
def loop():
    s = _Loop()
    yield s
    s.close()


def _flow(side, steps):
    """The flow of ``steps``: ("add", kwargs) with ``uses`` a key of SIDES,
    or ("needs_all", kwargs)."""
    p = SIDES[side]
    f = p["flow"]()
    for op, kw in steps:
        kw = dict(kw)
        if "uses" in kw:
            kw["uses"] = p[kw["uses"]]
        getattr(f, op)(**kw)
    return f


def _serve_flow(loop, side, steps):
    """Serve the flow in this process: each deployment's workers (and head
    when sharded) and the gateway, as ``Flow.start`` wires its pods.  The
    gateway's port."""
    p = SIDES[side]
    f = _flow(side, steps)
    graph = f.build()
    addresses = {}
    for dep in f._deployments.values():
        n = dep.replicas * dep.shards
        workers = [loop.serve(p["server"](p["worker"](
            uses=dep.uses, name=dep.name if n == 1 else f"{dep.name}/rep-{i}"), name="w"))
            for i in range(n)]
        addrs = [f"127.0.0.1:{w.port}" for w in workers]
        if dep.shards > 1:
            shards = {s: addrs[s * dep.replicas:(s + 1) * dep.replicas] for s in range(dep.shards)}
            polling = dep.polling if isinstance(dep.polling, dict) else \
                p["polling"](str(dep.polling).lower())
            head = loop.serve(p["server"](p["head"](shard_addresses=shards, polling=polling),
                                          name="h"))
            addrs = [f"127.0.0.1:{head.port}"]
        addresses[dep.name] = addrs
    deps = f._deployments.values()
    gateway = loop.serve(p["server"](p["gateway"](
        graph_representation=graph, executor_addresses=addresses,
        floating_deployments=[d.name for d in deps if d.floating],
        node_conditions={d.name: d.when for d in deps if d.when}), name="g"))
    return gateway.port


def _post(side, port, endpoint="/", n=3, target="", times=1):
    p = SIDES[side]

    async def run():
        client = p["client"](port=port)
        out = []
        for _ in range(times):
            docs = [p["doc"](id=f"d{i}", tags={"kind": "xy"[i % 2], "n": i}) for i in range(n)]
            resp = await client.apost(endpoint, docs, target_executor=target,
                                      return_responses=True, continue_on_error=True)
            st = resp.status if side == "port" else resp.proto.header.status
            out.append(([json.loads(d.to_json())["tags"] for d in resp.docs],
                        sorted(r.executor for r in resp.routes), int(st.code),
                        st.exception.name))
        if hasattr(client, "aclose"):
            await client.aclose()
        return out

    return asyncio.run(run())


TOPOLOGIES = {
    "chain": [("add", dict(uses="tagger", name="a")), ("add", dict(uses="tagger", name="b")),
              ("add", dict(uses="tagger", name="c"))],
    "branches_needs_all": [
        ("add", dict(uses="tagger", name="a")),
        ("add", dict(uses="tagger", name="b", needs="gateway")),
        ("add", dict(uses="tagger", name="c", needs=["a", "b"])),
        ("add", dict(uses="tagger", name="d", needs="a")),
        ("needs_all", dict(uses="tagger", name="join"))],
    "conditions": [
        ("add", dict(uses="tagger", name="a")),
        ("add", dict(uses="tagger", name="x", needs="a", when={"tags__kind": "x"})),
        ("add", dict(uses="tagger", name="y", needs="a", when={"tags__n": {"$gte": 1},
                                                               "tags__kind": {"$in": ["y"]}})),
        ("add", dict(uses="tagger", name="none", needs="a", when={"tags__kind": "z"})),
        ("needs_all", dict(uses="tagger", name="join"))],
    "floating_and_filtering": [
        ("add", dict(uses="tagger", name="a")),
        ("add", dict(uses="other", name="o")),
        ("add", dict(uses="tagger", name="f", needs="gateway", floating=True))],
    "shards_all": [("add", dict(uses="tagger", name="s", shards=2, polling="all")),
                   ("add", dict(uses="tagger", name="t"))],
    "shards_any_replicas": [("add", dict(uses="tagger", name="s", shards=2, replicas=2,
                                         polling="any"))],
    "polling_per_endpoint": [("add", dict(uses="tagger", name="s", shards=3,
                                          polling={"/tag": "any", "*": "all"}))],
    "replicas": [("add", dict(uses="tagger", name="r", replicas=3)),
                 ("add", dict(uses="tagger", name="z"))],
}


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_topologies_answer_as_the_jax_gateway(loop, name):
    """The same flow served in-process by each package answers the same
    requests alike (docs, route names, status), on ``/`` and ``/tag``, with
    a ``target_executor`` regex and with an endpoint a node fails on; the
    floating node still runs.  Replicas and ANY polling go round robin."""
    steps = TOPOLOGIES[name]
    assert _flow("port", steps).build() == _flow("jax", steps).build()
    got, want = {}, {}
    for side, out in (("port", got), ("jax", want)):
        SIDES[side]["tagger"].calls.clear()
        port = _serve_flow(loop, side, steps)
        out["root"] = _post(side, port, "/", times=4)
        out["tag"] = _post(side, port, "/tag", times=2)
        out["other"] = _post(side, port, "/other")
        out["target"] = _post(side, port, "/", target="a|s.*|r")
        out["fail"] = _post(side, port, "/fail")
        asyncio.run(asyncio.sleep(0.2))  # floating nodes finish
        out["calls"] = sorted(SIDES[side]["tagger"].calls)
    assert got == want
    if name == "floating_and_filtering":
        assert "f" in got["calls"] and all("f" not in t.get("seen", []) for t in
                                           got["root"][0][0])
        assert got["other"][0][0][0]["other"] is True and "other" not in got["root"][0][0][0]


def test_flow_api_and_refusals():
    """The Flow's graph, leaves and errors are the JAX flow's; a stateful
    deployment builds its replicas' RAFT peers."""
    f, j = Flow(), SIDES["jax"]["flow"]()
    for flow in (f, j):
        flow.add(name="a").add(name="b", needs="gateway").needs_all(name="c")
    assert f.build() == j.build()
    assert f._leaves() == j._leaves() == ["c"]
    assert f.config_gateway(prefetch=4) is f and f.prefetch == 4
    with pytest.raises(FlowTopologyError):
        Flow().add(name="a").add(name="a")
    with pytest.raises(FlowMissingDeploymentError):
        Flow().add(name="a", needs="nowhere")
    # a stateful deployment is ported: its replicas get RAFT peers, as in JAX
    stateful = Deployment(name="s", replicas=3, stateful=True)
    assert stateful.stateful and [p.kwargs["raft"]["node_id"] for p in stateful._worker_pods()] \
        == ["s-0", "s-1", "s-2"]
    # a Flow from YAML is ported (JAML): a missing file raises as in JAX
    from marie_tpu.excepts import BadConfigSource as JBadConfigSource
    from marie_tpu_torch.excepts import BadConfigSource

    with pytest.raises(BadConfigSource, match="cannot find config file"):
        Flow.load_config("flow.yml")
    with pytest.raises(JBadConfigSource, match="cannot find config file"):
        type(j).load_config("flow.yml")
    # discovery is ported: with no registry at the address, both gateways'
    # start_discovery fails UNAVAILABLE and keeps no topology
    import grpc

    from marie_tpu_torch.serve.networking.grpc_wire import RpcError, StatusCode

    async def no_registry(gate, error):
        try:
            await gate.start_discovery("127.0.0.1:1")
        except error as ex:
            return ex.code().name, gate.streamer.connection_pool.deployments()
        finally:
            await gate.stop_discovery()

    assert asyncio.run(no_registry(GatewayRequestHandler({"start-gateway": []}, {}), RpcError)) \
        == asyncio.run(no_registry(SIDES["jax"]["gateway"]({"start-gateway": []}, {}),
                                   grpc.aio.AioRpcError)) \
        == (StatusCode.UNAVAILABLE.name, [])
    for doc, cond in ((Document(tags={"a": {"b": 2}}), {"tags__a__b": {"$gt": 1, "$ne": 3}}),
                      (Document(text="t"), {"text": "t", "uri": {"$exists": False}})):
        from marie_tpu.serve.runtimes.gateway.conditions import doc_matches as jmatch

        jdoc = SIDES["jax"]["doc"](**{k: v for k, v in (("tags", doc.tags), ("text", doc.text))
                                      if v})
        assert doc_matches(doc, cond) == jmatch(jdoc, cond)


def _free(port: int) -> bool:
    with socket.socket() as s:
        try:
            s.bind(("127.0.0.1", port))
            return True
        except OSError:
            return False


def test_spawned_flow_with_a_sharded_deployment_answers_as_jax(loop):
    """``Flow().add(shards=2, polling="any").add(...)`` of the port in pods
    (gateway -> head -> two workers, then a worker) answers as the JAX
    package's gateway, head and workers on the same graph (served here),
    round robin over the shards; the gateway's dry_run is true; every
    child exits on close and its port is free again."""
    steps = [("add", dict(uses="tagger", name="s", shards=2, polling="any")),
             ("add", dict(uses="tagger", name="t"))]
    want = _post("jax", _serve_flow(loop, "jax", steps), "/", times=2)
    f = _flow("port", steps)
    with f:
        pods = list(f.pods)
        ports = [p.port for p in pods]
        assert len(pods) == 5 and f.gateway_address.endswith(str(f.port_gateway))
        got = _post("port", f.port_gateway, "/", times=2)
        assert GRPCClient(port=f.port_gateway).dry_run()
    assert got == want
    assert [r[0][0]["seen"] for r in got] == [["s/rep-0", "t"], ["s/rep-1", "t"]]
    assert not any(p.is_alive() for p in pods)
    assert all(_free(port) for port in ports)


def test_spawned_deployment_of_replicas_and_an_external_one(loop):
    """``Deployment(replicas=2)`` starts two worker pods over gRPC (no head);
    the pool goes round robin over them and fails over from a replica that
    does not answer; an ``external`` deployment points at a server this
    process runs; close stops the children and frees their ports."""
    from marie_tpu_torch.serve.networking import GrpcConnectionPool
    from marie_tpu_torch.types.request import DataRequest

    ext = loop.serve(GRPCServer(WorkerRequestHandler(uses=TTagger, name="ext"), name="e"))
    with Deployment(uses=TTagger, name="rep", replicas=2) as dep, \
            Deployment(name="ext", external=True, port=ext.port) as external:
        assert dep.head_pod is None and len(dep.addresses) == 2
        assert external.addresses == [f"127.0.0.1:{ext.port}"]

        async def run():
            pool = GrpcConnectionPool()
            for name, d in (("rep", dep), ("ext", external)):
                for addr in d.addresses:
                    pool.add_connection(name, addr)
            dead = socket.socket()
            dead.bind(("127.0.0.1", 0))  # a port nothing listens on
            pool.add_connection("flaky", f"127.0.0.1:{dead.getsockname()[1]}")
            pool.add_connection("flaky", f"127.0.0.1:{ext.port}")
            flaky = await pool.send_requests_once(  # UNAVAILABLE, reset, the next replica
                [DataRequest.from_docs([Document(id="a")], endpoint="/")], "flaky")
            dead.close()
            seen = [flaky.docs[0].tags["seen"][0]]
            for name in ("rep", "rep", "ext"):
                resp = await pool.send_requests_once(
                    [DataRequest.from_docs([Document(id="a")], endpoint="/")], name)
                seen.append(resp.docs[0].tags["seen"][0])
            eps = await pool.send_discover_endpoint("rep")
            await pool.close()
            return seen, eps

        seen, eps = asyncio.run(run())
        pods = list(dep.pods)
        ports = [p.port for p in pods]
    assert seen == ["ext", "rep/rep-0", "rep/rep-1", "ext"]
    assert eps["endpoints"] == ["/", "/fail", "/tag"]
    assert not any(p.is_alive() for p in pods) and all(p.exitcode is not None for p in pods)
    assert all(_free(port) for port in ports)
