"""The port's RAFT core (``marie_tpu_torch/csrc/raft.cpp``, built with g++
into ``marie_tpu_torch/_build/``) and its bindings, as
``tests/integration/test_consensus.py`` drives the JAX package's: one node
elects itself and commits, three replicate in one order and refuse writes
on followers, a killed leader is replaced, the stateful adapter applies a
write on every replica, and a snapshot compacts the log and installs on a
fresh follower.  A mixed cluster of one JAX node and two port nodes holds
the two copies of the core to one wire."""

import time

import pytest

from marie_tpu_torch.helper import random_port
from marie_tpu_torch.serve import consensus
from marie_tpu_torch.serve.consensus import LEADER, RaftNode
from marie_tpu_torch.serve.executors import BaseExecutor
from marie_tpu_torch.serve.executors.decorators import requests, write


class Counter(BaseExecutor):
    """``/incr`` (a write) counts documents."""

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


def _wait(cond, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return False


def _addrs(n):
    return [f"127.0.0.1:{random_port()}" for _ in range(n)]


def _wire(nodes, addrs, ids):
    for i, n in enumerate(nodes):
        for j, a in enumerate(addrs):
            if i != j:
                n.add_voter(ids[j], a)


@pytest.fixture
def cluster3():
    addrs = _addrs(3)
    ids = [f"n{i}" for i in range(3)]
    nodes = [RaftNode(ids[i], addrs[i]) for i in range(3)]
    _wire(nodes, addrs, ids)
    for n in nodes:
        n.start()
    yield nodes
    for n in nodes:
        n.shutdown()


def test_library_builds_from_the_ports_source():
    assert consensus._load() is not None  # builds the library when it is missing
    path = consensus.library_path()
    assert consensus.build_library() is None  # there now: nothing to build
    assert path.parent == consensus.BUILD_DIR and path.is_file()
    assert path.parent.parent.name == "marie_tpu_torch"
    assert consensus.SOURCE.parent.name == "csrc" and "native" not in str(path)
    # its own C++ runtime, bound to itself (beside CUDA torch, another
    # library's std:: copies crashed it)
    assert {"-static-libstdc++", "-Wl,--exclude-libs,ALL", "-Wl,-Bsymbolic"} <= \
        set(consensus.CXX_FLAGS)
    with open(path, "rb") as fp:
        elf = fp.read()
    assert elf[:4] == b"\x7fELF" and _dynamic_flags(elf) & 0x2  # DF_SYMBOLIC


def _dynamic_flags(elf: bytes) -> int:
    """DT_FLAGS of a little-endian ELF64 shared object (0 when absent)."""
    import struct

    shoff, = struct.unpack_from("<Q", elf, 0x28)
    shentsize, shnum = struct.unpack_from("<HH", elf, 0x3A)
    for i in range(shnum):
        sh_type, = struct.unpack_from("<I", elf, shoff + i * shentsize + 4)
        if sh_type != 6:  # SHT_DYNAMIC
            continue
        off, size = struct.unpack_from("<QQ", elf, shoff + i * shentsize + 0x18)
        for k in range(0, size, 16):
            tag, val = struct.unpack_from("<qQ", elf, off + k)
            if tag == 30:  # DT_FLAGS
                return val
    return 0


def test_single_node_self_elects_and_commits():
    node = RaftNode("solo", _addrs(1)[0])
    node.start()
    try:
        assert _wait(lambda: node.is_leader)
        assert node.submit(b"hello") == 1
        assert _wait(lambda: node.applied == [b"hello"])
        assert node.commit_index == 1 and node.leader_id == "solo"
    finally:
        node.shutdown()


def test_three_node_election_and_replication(cluster3):
    nodes = cluster3
    assert _wait(lambda: sum(n.is_leader for n in nodes) == 1)
    leader = next(n for n in nodes if n.is_leader)
    for k in range(3):
        assert leader.submit(f"e{k}\0".encode()) > 0  # a NUL inside survives
    assert _wait(lambda: all(len(n.applied) == 3 for n in nodes))
    for n in nodes:
        assert n.applied == [b"e0\0", b"e1\0", b"e2\0"]
    follower = next(n for n in nodes if not n.is_leader)
    assert follower.submit(b"nope") == 0
    cfg = leader.get_configuration()
    assert len(cfg["servers"]) == 3 and cfg["leader"] == leader.node_id


def test_leader_failover(cluster3):
    nodes = cluster3
    assert _wait(lambda: sum(n.is_leader for n in nodes) == 1)
    leader = next(n for n in nodes if n.is_leader)
    leader.submit(b"before")
    assert _wait(lambda: all(len(n.applied) == 1 for n in nodes))
    old_term = leader.term
    leader.shutdown()
    survivors = [n for n in nodes if n is not leader]
    nodes.remove(leader)
    assert _wait(lambda: any(n.is_leader for n in survivors), timeout=15)
    new_leader = next(n for n in survivors if n.is_leader)
    assert new_leader.term > old_term and new_leader.state == LEADER
    assert new_leader.submit(b"after") > 0
    assert _wait(lambda: all(n.applied[-1] == b"after" for n in survivors))
    assert all(n.applied == [b"before", b"after"] for n in survivors)


def test_stateful_adapter_replicates_executor_state():
    from marie_tpu_torch.serve.consensus.stateful import NotTheLeader, StatefulExecutorAdapter
    from marie_tpu_torch.serve.runtimes.worker.request_handling import WorkerRequestHandler
    from marie_tpu_torch.types.docs import Document, DocumentArray
    from marie_tpu_torch.types.request import DataRequest

    addrs = _addrs(3)
    adapters = []
    for i in range(3):
        a = StatefulExecutorAdapter(WorkerRequestHandler(executor=Counter(), name="c"),
                                    f"s{i}", addrs[i])
        for j, addr in enumerate(addrs):
            if j != i:
                a.add_voter(f"s{j}", addr)
        adapters.append(a)
    for a in adapters:
        a.start()
    try:
        assert _wait(lambda: sum(a.is_leader for a in adapters) == 1)
        leader = next(a for a in adapters if a.is_leader)
        follower = next(a for a in adapters if not a.is_leader)
        req = DataRequest.from_docs(DocumentArray([Document(text="x"), Document(text="y")]),
                                    endpoint="/incr")
        idx, result = leader.process_write(req)
        assert idx == 1 and [d.tags["counter"] for d in result.docs] == [2, 2]
        assert _wait(lambda: all(a.handler.executor.counter == 2 for a in adapters))
        assert _wait(lambda: all(a.applied_index == 1 for a in adapters))
        with pytest.raises(NotTheLeader):
            follower.process_write(DataRequest.from_docs(DocumentArray([Document()]), "/incr"))
        assert all(a.handler.executor.counter == 2 for a in adapters)
    finally:
        for a in adapters:
            a.shutdown()


def test_log_compaction_and_snapshot_install():
    n_entries = 1000
    leader = RaftNode("lead", _addrs(1)[0])
    leader.start()
    try:
        assert _wait(lambda: leader.is_leader)
        for k in range(n_entries):
            assert leader.submit(f"e{k}".encode()) > 0
        assert _wait(lambda: len(leader.applied) == n_entries, timeout=20)
        state = b"counter=" + str(n_entries).encode()
        assert leader.snapshot(state) == n_entries
        assert leader.log_length == 0 and leader.snapshot_index == n_entries
        for k in range(5):
            leader.submit(f"tail{k}".encode())
        assert _wait(lambda: len(leader.applied) == n_entries + 5)
        assert leader.log_length < n_entries
        f_addr = _addrs(1)[0]
        follower = RaftNode("f1", f_addr)
        follower.start()
        try:
            leader.add_voter("f1", f_addr)
            follower.add_voter("lead", leader.bind_addr)
            assert _wait(lambda: follower.restored == [state], timeout=15)
            assert _wait(lambda: [p.decode() for p in follower.applied]
                         == [f"tail{k}" for k in range(5)], timeout=15)
            assert follower.snapshot_index == n_entries
            assert follower.log_length < n_entries
        finally:
            follower.shutdown()
    finally:
        leader.shutdown()


def test_mixed_cluster_with_a_jax_node():
    """One node of the JAX package's core and two of the port's form one
    cluster: one leader, the same entries applied in the same order on all
    three, a follower's submit 0, the same configuration from each side's
    bindings (up to which node is ``self``)."""
    from marie_tpu.serve.consensus import RaftNode as JRaftNode

    addrs = _addrs(3)
    ids = ["jax", "port-a", "port-b"]
    nodes = [JRaftNode(ids[0], addrs[0]), RaftNode(ids[1], addrs[1]), RaftNode(ids[2], addrs[2])]
    assert nodes[0]._lib is not nodes[1]._lib and nodes[1]._lib is nodes[2]._lib
    _wire(nodes, addrs, ids)
    for n in nodes:
        n.start()
    try:
        assert _wait(lambda: sum(n.is_leader for n in nodes) == 1, timeout=15)
        leader = next(n for n in nodes if n.is_leader)
        payloads = [b"a\0b", b"c" * 70000, b"", b"\xff\x00\x01"]
        for p in payloads:
            assert leader.submit(p) > 0
        assert _wait(lambda: all(len(n.applied) == len(payloads) for n in nodes))
        assert all(n.applied == payloads for n in nodes)
        assert all(n.commit_index == len(payloads) for n in nodes)
        assert {n.leader_id for n in nodes} == {leader.node_id}
        assert len({n.term for n in nodes}) == 1
        for n in nodes:
            if n is not leader:
                assert n.submit(b"nope") == 0

        def normal(cfg):
            return (sorted((s["id"], s["addr"]) for s in cfg["servers"]), cfg["leader"],
                    cfg["term"])

        cfgs = [n.get_configuration() for n in nodes]
        assert normal(cfgs[0]) == normal(cfgs[1]) == normal(cfgs[2])
        assert [[s["id"] for s in c["servers"] if s["self"]] for c in cfgs] == [[i] for i in ids]
    finally:
        for n in nodes:
            n.shutdown()
