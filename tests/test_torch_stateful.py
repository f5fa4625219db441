"""A stateful (RAFT-replicated) deployment of the port, through its Flow,
gateway and connection pool, as ``tests/integration/test_stateful_deployment.py``
drives the JAX package's: a counter advances exactly once a post whichever
replica the pool picks first, reads are served locally by any replica, and
the counter goes on from where it was after the leader's pod is killed.
One Flow of three spawned replicas serves every case of the file (the
leader's kill comes last).  The module imports nothing of the JAX package,
so that the pods it spawns stay light."""

import asyncio
import time

import pytest

from marie_tpu_torch.clients import Client
from marie_tpu_torch.orchestrate.deployments import Deployment
from marie_tpu_torch.orchestrate.flow import Flow
from marie_tpu_torch.serve.executors import BaseExecutor
from marie_tpu_torch.serve.executors.decorators import requests, write
from marie_tpu_torch.types.docs import Document

NAME = "counter"


class StatefulCounter(BaseExecutor):
    """``/incr`` (a write) counts documents; ``/count`` (a read) reports
    the count."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.counter = 0

    @requests(on="/incr")
    @write
    def incr(self, docs, **kwargs):
        self.counter += len(docs)
        for d in docs:
            d.tags["counter"] = self.counter
        return docs

    @requests(on="/count")
    def count(self, docs, **kwargs):
        for d in docs:
            d.tags["counter"] = self.counter
        return docs


def _raft(pod):
    return Client(port=pod.port).info()["raft"]


@pytest.fixture(scope="module")
def stateful():
    """The Flow, and the writes the cases have made so far."""
    flow = Flow().add(uses=StatefulCounter, name=NAME, replicas=3, stateful=True)
    with flow:
        pods = flow._deployments[NAME].pods
        deadline = time.time() + 30
        while time.time() < deadline and not all(_raft(p)["leader"] for p in pods):
            time.sleep(0.1)
        yield {"flow": flow, "client": Client(port=flow.port_gateway), "writes": 0}
    assert all(p.exitcode is not None for p in pods)


def _incr(state, **kwargs):
    docs = state["client"].post("/incr", [Document()], **kwargs)
    state["writes"] += 1
    return int(docs[0].tags["counter"])


def test_deployment_gives_each_replica_its_raft_peers():
    """Each worker of a stateful deployment gets a node id, a RAFT port of
    its own and its peers'; ``env`` reaches every worker; a Flow's YAML
    ``stateful: true`` reaches the deployment."""
    dep = Deployment(uses=StatefulCounter, name="c", replicas=3, stateful=True,
                     env={"MARIE_HUB_DIR": "/nowhere"})
    pods = dep._worker_pods()  # built, not spawned
    raft = [p.kwargs["raft"] for p in pods]
    assert [r["node_id"] for r in raft] == ["c-0", "c-1", "c-2"]
    assert [p.name for p in pods] == ["c/rep-0", "c/rep-1", "c/rep-2"]
    addrs = {r["node_id"]: r["bind_addr"] for r in raft}
    assert len(set(addrs.values())) == 3
    for r in raft:
        assert sorted(r["peers"]) == sorted((i, a) for i, a in addrs.items()
                                            if i != r["node_id"])
    assert all(p.kwargs["env"] == {"MARIE_HUB_DIR": "/nowhere"} for p in pods)
    assert "raft" not in Deployment(uses=StatefulCounter, replicas=2)._worker_pods()[0].kwargs
    dep = Flow.load_config("jtype: Flow\nexecutors:\n  - name: s\n    replicas: 3\n"
                           "    stateful: true\n")._deployments["s"]
    assert dep.stateful and dep.replicas == 3


def test_stateful_replicas_converge_through_gateway(stateful):
    """The pool round-robins the replicas; followers answer "not the
    leader" and the pool retries until the leader applies the write, which
    replicates to every replica: the counter advances exactly once a post."""
    base = stateful["writes"]
    for k in range(1, 6):
        assert _incr(stateful) == base + k
    pods = stateful["flow"]._deployments[NAME].pods
    want = stateful["writes"]
    deadline = time.time() + 15
    while time.time() < deadline and {_raft(p)["applied_index"] for p in pods} != {want}:
        time.sleep(0.1)
    raft = [_raft(p) for p in pods]
    assert {r["commit_index"] for r in raft} == {r["applied_index"] for r in raft} == {want}
    assert len({r["leader"] for r in raft}) == 1 and len({r["term"] for r in raft}) == 1
    assert sorted(s["id"] for s in raft[0]["servers"]) == [f"{NAME}-{i}" for i in range(3)]


def test_stateful_reads_served_locally_without_consensus(stateful):
    """Undecorated endpoints are reads: any replica answers from its own
    state, never "not the leader", and every replica reaches the count."""
    for _ in range(2):
        _incr(stateful)
    want = stateful["writes"]
    client = stateful["client"]
    deadline = time.time() + 15
    streak = 0
    while time.time() < deadline and streak < 6:
        docs = client.post("/count", [Document()])
        got = int(docs[0].tags["counter"])
        assert got <= want, f"read overshot the write count: {got}"
        streak = streak + 1 if got == want else 0
        if streak == 0:
            time.sleep(0.3)
    assert streak == 6, "replicas never converged on local reads"


def test_stateful_leader_kill_preserves_state(stateful):
    """SIGKILL the leader's pod: the survivors elect a new leader, the pool
    retries through "not the leader" and UNAVAILABLE, and the counter goes
    on from its value before the kill, each write applied once."""
    for _ in range(2):
        _incr(stateful)
    before = stateful["writes"]
    pods = stateful["flow"]._deployments[NAME].pods
    leader_id = _raft(pods[0])["leader"]
    leader = next(p for i, p in enumerate(pods) if f"{NAME}-{i}" == leader_id)
    leader._process.kill()
    leader._process.join(5)
    survivors = [p for p in pods if p is not leader]
    deadline = time.time() + 30
    got = None
    while time.time() < deadline:
        try:
            got = _incr(stateful, max_attempts=3, initial_backoff=0.2)
            break
        except Exception:  # noqa: BLE001 — an election in progress
            time.sleep(0.5)
    assert got == before + 1, f"counter after failover: {got}"
    assert _incr(stateful) == before + 2
    raft = [_raft(p) for p in survivors]
    assert all(r["leader"] != leader_id and r["leader"] for r in raft)
    deadline = time.time() + 15
    while time.time() < deadline and {_raft(p)["applied_index"] for p in survivors} != \
            {before + 2}:
        time.sleep(0.1)
    assert {_raft(p)["applied_index"] for p in survivors} == {before + 2}


def test_pool_retries_only_not_the_leader():
    """The pool resends a write a follower refused to the next replica, with
    the status clear, and answers any other failure of the write as it
    stands (a leader's timeout may have applied it)."""
    from marie_tpu_torch.serve.consensus.stateful import NotTheLeader
    from marie_tpu_torch.serve.networking.connection_pool import GrpcConnectionPool
    from marie_tpu_torch.serve.runtimes.servers.grpc_server import GRPCServer
    from marie_tpu_torch.types.request import DataRequest

    seen = []

    class Replica:
        def __init__(self, name, answer):
            self.name, self.answer = name, answer

        async def process_data(self, reqs):
            req = reqs[0]
            seen.append((self.name, req.status.code))
            if self.answer == "ok":
                req.add_route(self.name)
                return req
            req.add_exception(NotTheLeader("x") if self.answer == "follower"
                              else TimeoutError("slow"), executor="raft")
            return req

        def endpoints(self):
            return {"endpoints": ["/w"]}

        def info(self):
            return {}

    async def run(answers):
        servers = [GRPCServer(Replica(f"r{i}", a)) for i, a in enumerate(answers)]
        for s in servers:
            await s.setup_server()
        pool = GrpcConnectionPool()
        for s in servers:
            pool.add_connection("d", f"127.0.0.1:{s.port}")
        try:
            return await pool.send_requests_once([DataRequest.from_docs([Document()], "/w")], "d")
        finally:
            await pool.close()
            for s in servers:
                await s.shutdown()

    resp = asyncio.run(run(["follower", "follower", "ok"]))
    assert not resp.is_error() and [r.executor for r in resp.routes] == ["r2"]
    assert seen == [("r0", 0), ("r1", 0), ("r2", 0)]
    seen.clear()
    resp = asyncio.run(run(["timeout", "ok"]))
    assert resp.is_error() and resp.status.exception.name == "TimeoutError"
    assert seen == [("r0", 0)]
    seen.clear()
    resp = asyncio.run(run(["follower"]))  # every attempt refused: the last answer
    assert resp.status.exception.name == "NotTheLeader" and len(seen) == 3
