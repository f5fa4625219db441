"""The port's gRPC server and client against the JAX package's (``grpcio``).

One loop thread serves the echo executor of ``tests/test_torch_serve.py``
twice: from the port's ``GRPCServer`` (the standard library's HTTP/2) and
from the JAX ``GRPCServer`` (``grpcio``), each over its own package's
worker handler.  The JAX client (``grpcio``) drives every service of the
port's server, and the port's client the JAX server: health, process_data
in both wire modes and with gzip / deflate, process_single_data, a ~20 MiB
message each way, 8 calls in flight on one channel, the bidirectional
``Call`` in order, ``stream_doc``, dry_run, ``_status``, endpoint discovery,
snapshot / restore, deadlines, cancellation, the message limit and the
Bearer-key guard.  Answers are compared with request ids, route times
and exception stacks left out."""

import asyncio
import json
import time

import grpc
import numpy as np
import pytest

from marie_tpu.clients.grpc_client import GRPCClient as JGRPCClient
from marie_tpu.proto import marie_pb2
from marie_tpu.serve.runtimes.servers.grpc_server import GRPCServer as JGRPCServer
from marie_tpu.serve.runtimes.worker.request_handling import (
    WorkerRequestHandler as JWorkerRequestHandler,
)
from marie_tpu.types.docs import Document as JDocument
from marie_tpu.types.request import DataRequest as JDataRequest
from marie_tpu.types.request import to_request_list_bytes as jto_list
from marie_tpu_torch.clients import Client, GRPCClient
from marie_tpu_torch.serve.networking.grpc_wire import RpcError, StatusCode
from marie_tpu_torch.serve.runtimes.servers.grpc_server import GRPCServer
from marie_tpu_torch.serve.runtimes.worker.request_handling import WorkerRequestHandler
from marie_tpu_torch.types.docs import Document
from tests.test_torch_serve import SEED, JEcho, TEcho, _Loop

_IDENT = lambda b: b  # noqa: E731 — raw bytes in and out
_OPTIONS = [("grpc.max_send_message_length", 64 << 20),
            ("grpc.max_receive_message_length", 64 << 20)]


@pytest.fixture(scope="module")
def servers():
    s = _Loop()
    s.port = s.serve(GRPCServer(WorkerRequestHandler(uses=TEcho, name="echo"), name="t"))
    s.jax = s.serve(JGRPCServer(JWorkerRequestHandler(uses=JEcho, name="echo"), name="t"))
    yield s
    s.close()


def _docs(cls, n=2):
    rng = np.random.default_rng(SEED)
    return [cls(id=f"d{i}", text=f"t{i}", tags={"k": i, "n": {"x": [1, None]}},
                tensor=rng.integers(0, 255, (2, 3), dtype=np.uint8)) for i in range(n)]


def _answer(resp):
    """A response as comparable data: docs, parameters, status, route names."""
    st = resp.status if hasattr(resp, "header") else resp.proto.header.status
    exc = st.exception
    return ([json.loads(d.to_json()) for d in resp.docs], resp.parameters,
            (int(st.code), st.description, exc.name, list(exc.args), exc.executor),
            [r.executor for r in resp.routes], resp.wire_mode)


def _call(stub, *args, **kwargs):
    """A grpcio call's (code, details, response) with its error caught."""
    async def run():
        try:
            return StatusCode.OK, "", await stub(*args, **kwargs)
        except grpc.aio.AioRpcError as ex:
            return StatusCode(ex.code().value[0]), ex.details(), None
    return run()


# --- the JAX client (grpcio) against the port's server -------------------
@pytest.mark.parametrize("endpoint,mode,compression", [
    ("/echo", "docs_bytes", None), ("/echo", "docs", "Gzip"), ("/stats", "docs_bytes", "Deflate"),
    ("/boom", "docs", None), ("/missing", "docs_bytes", None), ("/stream", "docs", "Gzip")])
def test_process_data_answers_as_the_jax_server(servers, endpoint, mode, compression):
    """grpcio's channel (with the compression) sends the same
    DataRequestListProto to both servers: the same answer, in the request's
    wire mode."""
    async def run():
        out = []
        for port in (servers.port.port, servers.jax.port):
            async with grpc.aio.insecure_channel(
                    f"127.0.0.1:{port}", options=_OPTIONS,
                    compression=getattr(grpc.Compression, compression) if compression
                    else None) as ch:
                req = JDataRequest.from_docs(_docs(JDocument), endpoint=endpoint,
                                             parameters={"suffix": "s", "scale": 2})
                req.wire_mode = mode
                stub = ch.unary_unary("/jina.JinaDataRequestRPC/process_data",
                                      request_serializer=_IDENT,
                                      response_deserializer=JDataRequest.from_bytes)
                out.append(_answer(await stub(jto_list([req]))))
                single = ch.unary_unary("/jina.JinaSingleDataRequestRPC/process_single_data",
                                        request_serializer=_IDENT,
                                        response_deserializer=JDataRequest.from_bytes)
                out.append(_answer(await single(req.to_bytes())))
        return out

    port, port_single, jax, jax_single = asyncio.run(run())
    assert port == jax and port_single == jax_single
    assert port[4] == mode


def test_health_info_discovery_dry_run_and_snapshots(servers, tmp_path):
    """The small services answer as the JAX server's: health SERVING
    (unguarded), _status, endpoint discovery, dry_run; a snapshot of an
    executor without one FAILED, unknown ids NOT_FOUND, a restore outside
    the snapshot directory FAILED."""
    async def run(port):
        async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as ch:
            def raw(path):
                return ch.unary_unary(path, request_serializer=_IDENT,
                                      response_deserializer=_IDENT)
            health = await raw("/grpc.health.v1.Health/Check")(b"")
            info = marie_pb2.JinaInfoProto.FromString(await raw("/jina.JinaInfoRPC/_status")(b""))
            eps = marie_pb2.EndpointsProto.FromString(
                await raw("/jina.JinaDiscoverEndpointsRPC/endpoint_discovery")(b""))
            dry = marie_pb2.StatusProto.FromString(await raw("/jina.JinaGatewayDryRunRPC/dry_run")(b""))
            snap = marie_pb2.SnapshotStatusProto.FromString(
                await raw("/jina.JinaExecutorSnapshot/snapshot")(b""))
            known = marie_pb2.SnapshotStatusProto.FromString(
                await raw("/jina.JinaExecutorSnapshotProgress/snapshot_status")(
                    snap.id.SerializeToString()))
            unknown = marie_pb2.SnapshotStatusProto.FromString(
                await raw("/jina.JinaExecutorSnapshotProgress/snapshot_status")(
                    marie_pb2.SnapshotId(value="nope").SerializeToString()))
            restore = marie_pb2.RestoreSnapshotStatusProto.FromString(
                await raw("/jina.JinaExecutorRestore/restore")(marie_pb2.RestoreSnapshotCommand(
                    snapshot_file=str(tmp_path / "../../etc/passwd")).SerializeToString()))
            rknown = marie_pb2.RestoreSnapshotStatusProto.FromString(
                await raw("/jina.JinaExecutorRestoreProgress/restore_status")(
                    restore.id.SerializeToString()))
            return (health, bool(info.jina), list(eps.endpoints), list(eps.write_endpoints),
                    dry.code, snap.status, known.status, unknown.status, restore.status,
                    rknown.status, "device" in info.jina or "jax" in info.jina)

    port, jax = asyncio.run(run(servers.port.port)), asyncio.run(run(servers.jax.port))
    assert port == jax
    assert port[0] == b"\x08\x01" and port[4] == 0 and port[5] == port[6] == 5
    assert port[7] == 6 and port[8] == port[9] == 3 and port[10]


def test_large_messages_each_way_and_the_limit(servers):
    """A ~20 MiB tensor goes to each server and back through both clients
    (windows honoured and replenished both ways); a message past 64 MiB
    gets RESOURCE_EXHAUSTED from the port's server."""
    big = np.random.default_rng(SEED).integers(0, 255, (20 << 20,), dtype=np.uint8)

    async def run():
        out = []
        for port in (servers.port.port, servers.jax.port):
            for client in (JGRPCClient(port=port), GRPCClient(port=port)):
                doc = (JDocument if isinstance(client, JGRPCClient) else Document)(
                    id="big", tensor=big)
                t = time.perf_counter()
                docs = await client.apost("/echo", [doc])
                out.append((np.array_equal(docs[0].tensor, big), docs[0].text,
                            time.perf_counter() - t))
                if isinstance(client, GRPCClient):
                    await client.aclose()
        client = GRPCClient(port=servers.port.port)
        client._channel().max_message = 80 << 20  # let this side send past the limit
        try:
            await client.apost("/echo", [Document(id="x", blob=b"\x00" * ((64 << 20) + 1))])
        except RpcError as ex:
            out.append((ex.code(), "larger than max" in ex.details()))
        await client.aclose()
        return out

    out = asyncio.run(run())
    assert [o[:2] for o in out[:4]] == [(True, "echo:None:")] * 4
    assert out[4] == (StatusCode.RESOURCE_EXHAUSTED, True)


def test_eight_calls_in_flight_on_one_channel(servers):
    """8 calls of the 0.6 s ``/slow`` endpoint on one grpcio channel (and on
    one port channel) overlap: all answer, in well under 8 x 0.6 s."""
    async def run():
        walls = []
        async with grpc.aio.insecure_channel(f"127.0.0.1:{servers.port.port}") as ch:
            stub = ch.unary_unary("/jina.JinaDataRequestRPC/process_data",
                                  request_serializer=_IDENT,
                                  response_deserializer=JDataRequest.from_bytes)
            t = time.perf_counter()
            resps = await asyncio.gather(*(stub(jto_list([JDataRequest.from_docs(
                [JDocument(id=f"s{i}")], endpoint="/slow")])) for i in range(8)))
            walls.append(time.perf_counter() - t)
        client = GRPCClient(port=servers.jax.port)
        t = time.perf_counter()
        tresps = await asyncio.gather(*(client.apost("/slow", [Document(id=f"s{i}")])
                                        for i in range(8)))
        walls.append(time.perf_counter() - t)
        await client.aclose()
        return [r.docs[0].id for r in resps], [d[0].id for d in tresps], walls

    ids, tids, walls = asyncio.run(run())
    assert ids == tids == [f"s{i}" for i in range(8)]
    assert max(walls) < 8 * 0.6 / 2, walls


def test_bidi_call_stream_doc_and_client_streams(servers):
    """``Call`` answers a worker's requests in order (JAX client on the
    port's server, the port's client on the JAX server); ``stream_doc``
    yields a generator endpoint's documents as each package's does."""
    async def jax_side():
        client = JGRPCClient(port=servers.port.port)
        reqs = [JDataRequest.from_docs([JDocument(id=f"b{i}", text="t")], endpoint="/echo")
                for i in range(5)]
        ids = [r.docs[0].id async for r in client.astream(iter(reqs))]
        streamed = [(d.id, d.text) async for d in client.astream_doc(
            "/stream", JDocument(id="q", text="x"))]
        return ids, streamed

    async def port_side(port):
        client = GRPCClient(port=port)
        from marie_tpu_torch.types.request import DataRequest

        reqs = [DataRequest.from_docs([Document(id=f"b{i}", text="t")], endpoint="/echo")
                for i in range(5)]
        ids = [r.docs[0].id async for r in client.astream(iter(reqs))]
        streamed = [(d.id, d.text) async for d in client.astream_doc(
            "/stream", Document(id="q", text="x"))]
        await client.aclose()
        return ids, streamed

    want = ([f"b{i}" for i in range(5)], [("q-0", "x/0"), ("q-1", "x/1")])
    assert asyncio.run(jax_side()) == want
    assert asyncio.run(port_side(servers.jax.port)) == want
    assert asyncio.run(port_side(servers.port.port)) == want


def test_deadline_and_cancel(servers):
    """A call past its deadline gets DEADLINE_EXCEEDED from either server
    and either client; a call cancelled by the client (RST_STREAM CANCEL)
    cancels the port server's handler task."""
    async def run():
        out = []
        for port in (servers.port.port, servers.jax.port):
            async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as ch:
                stub = ch.unary_unary("/jina.JinaDataRequestRPC/process_data",
                                      request_serializer=_IDENT, response_deserializer=_IDENT)
                req = jto_list([JDataRequest.from_docs([JDocument(id="s")], endpoint="/slow")])
                out.append((await _call(stub, req, timeout=0.2))[0])
            client = GRPCClient(port=port)
            try:
                await client.apost("/slow", [Document(id="s")], timeout=0.2)
            except RpcError as ex:
                out.append(ex.code())
            await client.aclose()
        tasks = servers.port.server._tasks
        async with grpc.aio.insecure_channel(f"127.0.0.1:{servers.port.port}") as ch:
            stub = ch.unary_unary("/jina.JinaDataRequestRPC/process_data",
                                  request_serializer=_IDENT, response_deserializer=_IDENT)
            call = stub(jto_list([JDataRequest.from_docs([JDocument(id="c")], endpoint="/slow")]))
            await asyncio.sleep(0.2)
            during = len(tasks)
            call.cancel()
            await asyncio.sleep(0.1)
            out += [during, len(tasks)]
        return out

    out = asyncio.run(run())
    assert out[:4] == [StatusCode.DEADLINE_EXCEEDED] * 4
    assert out[4] == 1 and out[5] == 0


def test_bearer_key_guard(servers, monkeypatch):
    """With API keys set, every call but health needs the Bearer key:
    UNAUTHENTICATED from both servers to both clients without it."""
    from marie_tpu.auth import APIKeyManager as JKeys
    from marie_tpu_torch.auth import APIKeyManager as TKeys

    monkeypatch.setattr(JKeys, "_keys", {})
    monkeypatch.setattr(TKeys, "_keys", {})
    TKeys.from_config([{"name": "n", "api_key": "mas_k"}])
    JKeys.from_config([{"name": "n", "api_key": "mas_k"}])

    async def run():
        out = []
        for port in (servers.port.port, servers.jax.port):
            for cls, doc in ((JGRPCClient, JDocument), (GRPCClient, Document)):
                client, keyed = cls(port=port), cls(port=port, api_key="mas_k")
                try:
                    await client.apost("/echo", [doc(id="a")])
                    out.append("ok")
                except (grpc.aio.AioRpcError, RpcError) as ex:
                    code = ex.code()
                    out.append(code.name if hasattr(code, "name") else code)
                got = await keyed.apost("/echo", [doc(id="a")])
                out.append(got[0].text)
                for c in (client, keyed):
                    if hasattr(c, "aclose"):
                        await c.aclose()
            client = GRPCClient(port=port)
            out.append(await client.ahealth())
            await client.aclose()
        return out

    out = asyncio.run(run())
    assert out == ["UNAUTHENTICATED", "echo:None:", "UNAUTHENTICATED", "echo:None:", 1] * 2


def test_port_client_sync_api_and_factory(servers):
    """``Client(protocol="grpc")`` (the default) is the gRPC client; its
    sync calls answer as the JAX client's on the JAX server, with and
    without gzip / deflate and in either wire mode."""
    port_client = Client(port=servers.jax.port)
    jax_client = JGRPCClient(port=servers.jax.port)
    assert isinstance(port_client, GRPCClient)
    got = port_client.post("/stats", _docs(Document), parameters={"scale": 4},
                           return_responses=True)
    want = jax_client.post("/stats", _docs(JDocument), parameters={"scale": 4},
                           return_responses=True)
    assert _answer(got) == _answer(want)
    assert port_client.dry_run() and port_client.flow_ready()
    assert port_client.info()["marie_tpu"] == jax_client.info()["marie_tpu"]
    prof = port_client.profiling()
    assert set(prof) == {"total_seconds", "executors", "network_and_gateway_seconds"}
    errors = []
    port_client.post("/boom", [Document(id="e")], on_error=errors.append)
    assert errors and errors[0].status.exception.name == "RuntimeError"
    for compression in ("Gzip", "Deflate"):  # grpcio's server reads both
        docs = Client(port=servers.jax.port, compression=compression,
                      wire_mode="docs").post("/echo", _docs(Document), parameters={"suffix": "z"})
        assert [d.text for d in docs] == ["echo:t0:z", "echo:t1:z"]
