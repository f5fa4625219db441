"""The port's observability and the rest of its gateway surface against
the JAX package's: W3C traces (``serve/instrumentation/tracing.py``)
across gRPC hops both ways, the JSONL and OTLP exports, the OpenTelemetry
and prometheus_client guards, a pod's monitoring port, the Sagemaker and
Azure apps, ``CompositeServer`` and CORS.

One loop thread serves the echo executor of ``tests/test_torch_serve.py``
from each package's servers, each over its own package's worker handler;
answers are compared with request ids and route times masked."""

import asyncio
import http.client
import json
import sys
import urllib.request

import pytest

from marie_tpu.clients.grpc_client import GRPCClient as JGRPCClient
from marie_tpu.serve.instrumentation import InstrumentationMixin as JInstrumentationMixin
from marie_tpu.serve.instrumentation import MetricsTimer as JMetricsTimer
from marie_tpu.serve.instrumentation import tracing as jtracing
from marie_tpu.serve.monitoring import MonitoringMixin as JMonitoringMixin
from marie_tpu.serve.runtimes.servers.cloud_http import AzureHTTPServer as JAzureHTTPServer
from marie_tpu.serve.runtimes.servers.cloud_http import (
    SagemakerHTTPServer as JSagemakerHTTPServer)
from marie_tpu.serve.runtimes.servers.composite import CompositeServer as JCompositeServer
from marie_tpu.serve.runtimes.servers.grpc_server import GRPCServer as JGRPCServer
from marie_tpu.serve.runtimes.servers.http_server import HTTPServer as JHTTPServer
from marie_tpu.serve.runtimes.worker.request_handling import (
    WorkerRequestHandler as JWorkerRequestHandler)
from marie_tpu.types.docs import Document as JDocument
from marie_tpu_torch.clients import Client, GRPCClient
from marie_tpu_torch.helper import random_port
from marie_tpu_torch.serve.instrumentation import InstrumentationMixin, MetricsTimer, tracing
from marie_tpu_torch.serve.monitoring import MonitoringMixin
from marie_tpu_torch.serve.runtimes.gateway.request_handling import GatewayRequestHandler
from marie_tpu_torch.serve.runtimes.servers import (
    AzureHTTPServer, CompositeServer, GRPCServer, HTTPServer, SagemakerHTTPServer)
from marie_tpu_torch.serve.runtimes.worker.request_handling import WorkerRequestHandler
from marie_tpu_torch.types.docs import Document
from tests.test_torch_serve import JEcho, TEcho, _ask, _Loop, _masked


@pytest.fixture(scope="module")
def servers():
    s = _Loop()
    th = WorkerRequestHandler(uses=TEcho, name="echo")
    jh = JWorkerRequestHandler(uses=JEcho, name="echo")
    s.grpc = s.serve(GRPCServer(th, name="echo"))
    s.jgrpc = s.serve(JGRPCServer(jh, name="echo"))
    s.cors = s.serve(HTTPServer(th, cors=True))
    s.jcors = s.serve(JHTTPServer(jh, cors=True))
    s.cloud = {cls.__name__: s.serve(cls(h, port=random_port()))
               for cls, h in ((SagemakerHTTPServer, th), (AzureHTTPServer, th))}
    s.jcloud = {cls.__name__: s.serve(cls(h, port=random_port()))
                for cls, h in ((JSagemakerHTTPServer, jh), (JAzureHTTPServer, jh))}
    protocols = ("grpc", "http", "websocket")
    s.composite = s.serve(CompositeServer(th, protocols=protocols))
    s.jcomposite = s.serve(JCompositeServer(jh, protocols=protocols))
    # client -> gateway -> worker, all the port's, in this process
    s.gateway = s.serve(GRPCServer(GatewayRequestHandler(
        {"start-gateway": ["echo"], "echo": ["end-gateway"]}, {"echo": [s.grpc.address]})))
    yield s
    s.close()


# --- traces -----------------------------------------------------------------
def test_traceparent_round_trip_nesting_and_collector():
    """A root's traceparent parses back to it (the JAX module's too) and
    garbage does not; spans nest under the active one; the metadata gets
    the active traceparent after what it had."""
    ctx = tracing.SpanContext.new_root()
    header = ctx.to_traceparent()
    assert header.startswith("00-") and header.endswith("-01") and len(header) == 55
    assert tracing.SpanContext.from_traceparent(header) == ctx
    assert jtracing.SpanContext.from_traceparent(header) == jtracing.SpanContext(
        ctx.trace_id, ctx.span_id)
    for bad in ("garbage", "01-" + header[3:], header[:-3], ""):
        assert tracing.SpanContext.from_traceparent(bad) is None
        assert jtracing.SpanContext.from_traceparent(bad) is None
    tracing.collector.drain()
    with tracing.start_span("outer", {"k": 1}) as outer:
        with tracing.start_span("inner") as inner:
            md = tracing.inject_metadata((("authorization", "Bearer x"),))
    spans = {s.name: s for s in tracing.collector.drain()}
    assert spans["inner"].trace_id == spans["outer"].trace_id == inner.trace_id == outer.trace_id
    assert spans["inner"].parent_span_id == spans["outer"].span_id
    assert spans["outer"].parent_span_id is None
    assert md == (("authorization", "Bearer x"), ("traceparent", f"00-{inner.trace_id}-"
                                                                  f"{inner.span_id}-01"))
    assert tracing.inject_metadata(None) == () and tracing.current_traceparent() is None
    assert tracing.extract_metadata(md) == tracing.SpanContext(inner.trace_id, inner.span_id)
    with tracing.activate(header) as active:
        assert active == ctx and tracing.current_context() == ctx
    with pytest.raises(RuntimeError):
        with tracing.start_span("failing"):
            raise RuntimeError("x")
    assert tracing.collector.drain()[0].attributes["error"] == "RuntimeError('x')"


def _trace(spans, names):
    by = {s.name: s for s in spans}
    return [by[n] for n in names]


def test_one_trace_id_across_packages_both_ways(servers):
    """grpcio's JAX client against the port's server, and the port's client
    against the JAX server (grpcio): the client's ``client/post`` span and
    the server's ``rpc/echo`` span share the trace id, the server's under
    the client's."""
    async def jax_to_port():
        jtracing.collector.drain()
        tracing.collector.drain()
        docs = await JGRPCClient(port=servers.grpc.port).apost("/echo", [JDocument(text="t")])
        return docs.texts, jtracing.collector.drain(), tracing.collector.drain()

    async def port_to_jax():
        jtracing.collector.drain()
        tracing.collector.drain()
        client = GRPCClient(port=servers.jgrpc.port)
        docs = await client.apost("/echo", [Document(text="t")])
        await client.aclose()
        return docs.texts, tracing.collector.drain(), jtracing.collector.drain()

    for run in (jax_to_port, port_to_jax):
        texts, client_spans, server_spans = asyncio.run(run())
        assert texts == ["echo:t:"]
        (client,) = _trace(client_spans, ["client/post"])
        (rpc,) = _trace(server_spans, ["rpc/echo"])
        assert rpc.trace_id == client.trace_id and rpc.parent_span_id == client.span_id
        assert rpc.attributes["endpoint"] == "/echo"


def test_client_gateway_worker_share_one_trace(servers):
    """The port's client -> gateway -> worker: ``client/post``, the
    gateway's ``rpc/handler`` and the worker's ``rpc/echo`` are one trace,
    each under the one before (the pool carried the gateway's context)."""
    async def run():
        tracing.collector.drain()
        with tracing.start_span("caller") as caller:
            client = Client(port=servers.gateway.port)
            docs = await client.apost("/echo", [Document(text="g")])
            await client.aclose()
        return caller, docs.texts, tracing.collector.drain()

    caller, texts, spans = asyncio.run(run())
    assert texts == ["echo:g:"]
    post, gate, worker = _trace(spans, ["client/post", "rpc/handler", "rpc/echo"])
    assert {post.trace_id, gate.trace_id, worker.trace_id} == {caller.trace_id}
    assert (post.parent_span_id, gate.parent_span_id, worker.parent_span_id) == (
        caller.span_id, post.span_id, gate.span_id)


def test_jsonl_and_otlp_exports_equal_jax(tmp_path):
    """The same spans give the JAX module's ``to_dict``, JSONL lines and
    OTLP/HTTP JSON body; ``export_otlp_http`` posts that body to
    ``/v1/traces`` (a failed post requeues the spans)."""
    rows = [("a", "0" * 31 + "1", "1" * 16, None, 1.5, 2.25, {"k": 1, "s": "v"}),
            ("b", "0" * 31 + "1", "2" * 16, "1" * 16, 1.75, 2.0, {})]
    mine = [tracing.Span(*r[:5], end=r[5], attributes=dict(r[6])) for r in rows]
    theirs = [jtracing.Span(*r[:5], end=r[5], attributes=dict(r[6])) for r in rows]
    assert [s.to_dict() for s in mine] == [s.to_dict() for s in theirs]
    assert tracing.spans_to_otlp(mine, "svc") == jtracing.spans_to_otlp(theirs, "svc")
    files = []
    for mod, spans, name in ((tracing, mine, "port"), (jtracing, theirs, "jax")):
        collector = mod.SpanCollector(max_spans=1)
        for s in spans:
            collector.add(s)
        assert len(collector.snapshot()) == 1  # the ring keeps the newest
        for s in spans:
            collector.add(s)
        collector.max_spans = 10
        collector.add(spans[0])
        path = tmp_path / f"{name}.jsonl"
        assert collector.export_jsonl(str(path)) == 2
        files.append(path.read_text())
    assert files[0] == files[1]

    got = []

    async def traces(request):
        got.append((request.path, request.json()))
        from marie_tpu_torch.serve.runtimes.servers.http_server import json_response

        return json_response({})

    loop = _Loop()
    sink = loop.serve(HTTPServer(None, routes=[("POST", "/v1/traces", traces)]))
    try:
        bodies = []
        for mod, spans in ((tracing, mine), (jtracing, theirs)):
            mod.collector.drain()
            for s in spans:
                mod.collector.add(s)
            assert mod.export_otlp_http(f"http://127.0.0.1:{sink.port}", "svc") == 2
            bodies.append(got.pop())
        assert bodies[0] == bodies[1] == ("/v1/traces", tracing.spans_to_otlp(mine, "svc"))
        tracing.collector.add(mine[0])
        assert tracing.export_otlp_http(f"http://127.0.0.1:{random_port()}", timeout=2) == 0
        assert [s.name for s in tracing.collector.drain()] == ["a"]
    finally:
        loop.close()


def test_guards_without_opentelemetry_and_prometheus_client(monkeypatch):
    """Without the optional libraries (as on the card): both packages'
    InstrumentationMixin keeps no tracer or meter and, for a traces
    exporter host, runs the collector's OTLP/HTTP exporter;
    MonitoringMixin keeps ``metrics_registry`` None and its summary and
    counter are None; MetricsTimer feeds what it was given."""
    for name in ("opentelemetry", "prometheus_client"):
        monkeypatch.setitem(sys.modules, name, None)
    out = []
    for instr, mon, timer in ((InstrumentationMixin, MonitoringMixin, MetricsTimer),
                              (JInstrumentationMixin, JMonitoringMixin, JMetricsTimer)):
        i = instr()
        i._setup_instrumentation("svc", tracing=True, traces_exporter_host="127.0.0.1",
                                 traces_exporter_port=1, metrics=True)
        stop = i._otlp_stop
        stop.set()
        m = mon()
        m._setup_monitoring(monitoring=True, port_monitoring=random_port())
        off = mon()
        off._setup_monitoring()

        class Summary:
            seen = []

            def observe(self, v):
                self.seen.append(v)

        with timer(summary=Summary()):
            pass
        out.append((i.tracer, i.meter, m.metrics_registry, m.summary("s", "d"),
                    m.counter("c", "d"), off.metrics_registry, len(Summary.seen)))
    assert out[0] == out[1] == (None, None, None, None, None, None, 1)


def test_pod_monitoring_port():
    """``tests/integration/test_observability.py::test_pod_monitoring_port``
    in port form: a gRPC worker pod serves ``/metrics`` on its own
    ``port_monitoring`` (the request metrics of its executor), and both
    ports are free once it is closed."""
    import socket

    from marie_tpu_torch.orchestrate.pods import Pod

    mport = random_port()
    with Pod("worker", uses="marie_tpu_torch.executor.TextExtractionExecutorMock",
             name="obs-pod", port_monitoring=mport) as pod:
        Client(port=pod.port).post("/document/extract", [Document(text="x")])
        body = urllib.request.urlopen(f"http://127.0.0.1:{mport}/metrics", timeout=30).read()
        port = pod.port
    text = body.decode()
    assert "marie_request_seconds" in text and 'executor="obs-pod"' in text
    for p in (port, mport):
        with socket.socket() as s:
            s.bind(("127.0.0.1", p))


# --- the gateway's HTTP surface --------------------------------------------
CLOUD_CASES = [
    ("GET", "/ping", None, {}),
    ("POST", "/invocations", [{"text": "hello"}], {"X-Marie-Endpoint": "/echo"}),
    ("POST", "/invocations", b"alpha,k=v\nbeta\n\ngamma,x=1,bad", {
        "Content-Type": "text/csv", "X-Marie-Endpoint": "/echo"}),
    ("POST", "/invocations", b"a,b", {"Content-Type": "application/csv; charset=utf-8",
                                     "X-Marie-Endpoint": "/echo"}),
    ("POST", "/invocations", {"data": [{"text": "p"}], "execEndpoint": "/echo",
                              "parameters": {"suffix": "s"}}, {}),
    ("POST", "/invocations", [{"text": "d"}], {}),  # the default endpoint: none here
    ("POST", "/invocations", b"{nope", {}),
    ("POST", "/score", {"data": [{"text": "az"}], "execEndpoint": "/echo"}, {}),
    ("GET", "/health", None, {}),
]


@pytest.mark.parametrize("app", ["SagemakerHTTPServer", "AzureHTTPServer"])
@pytest.mark.parametrize("method,path,body,headers", CLOUD_CASES,
                         ids=[f"{m} {p} {i}" for i, (m, p, _, _) in enumerate(CLOUD_CASES)])
def test_cloud_apps_answer_as_jax(servers, app, method, path, body, headers):
    """``tests/integration/test_cloud_http.py``'s contract and more, on both
    packages' apps: the same status codes and JSON bodies."""
    got = _ask(servers.cloud[app].port, method, path, body, headers)
    want = _ask(servers.jcloud[app].port, method, path, body, headers)
    assert got[0] == want[0], (got, want)
    if (want[1] or "").startswith("application/json"):
        got, want = _masked(got[2]), _masked(want[2])
        for body in (got, want):  # docs made from CSV lines or bare lists get fresh ids
            for d in body.get("data", []) if isinstance(body, dict) else ():
                d["id"] = "*"
        assert got == want
    if (app, path) == ("SagemakerHTTPServer", "/score"):
        assert got[0] == 404  # only Azure has /score
    if path == "/ping":
        assert got == {}


def test_cloud_port_default():
    from marie_tpu.serve.runtimes.servers.cloud_http import CLOUD_PORT as JCLOUD_PORT
    from marie_tpu_torch.serve.runtimes.servers.cloud_http import CLOUD_PORT

    assert CLOUD_PORT == JCLOUD_PORT == 8080
    assert SagemakerHTTPServer(None).port == AzureHTTPServer(None).port == 8080
    assert SagemakerHTTPServer(None, port=9001).port == 9001


def test_composite_server_answers_on_three_protocols(servers):
    """One handler behind gRPC, HTTP and WebSocket at once, each on its own
    port: each package's clients get the same docs from the port's
    composite as from the JAX one."""
    async def run(composite):
        out = []
        for server, proto in zip(composite.servers, ("grpc", "http", "websocket")):
            client = Client(port=server.port, protocol=proto)
            docs = await client.apost("/echo", [Document(text=proto)],
                                      parameters={"suffix": "c"})
            if hasattr(client, "aclose"):
                await client.aclose()
            out.append(docs.texts)
        return out

    port = asyncio.run(run(servers.composite))
    assert port == asyncio.run(run(servers.jcomposite)) == [
        ["echo:grpc:c"], ["echo:http:c"], ["echo:websocket:c"]]
    assert [type(s).__name__ for s in servers.composite.servers] == [
        type(s).__name__ for s in servers.jcomposite.servers]
    assert servers.composite.port == servers.composite.servers[0].port
    assert [a.split(":")[0] for a in servers.composite.addresses] == [
        a.split(":")[0] for a in servers.jcomposite.addresses] == ["127.0.0.1", "http", "ws"]


CORS = ("Access-Control-Allow-Origin", "Access-Control-Allow-Methods",
        "Access-Control-Allow-Headers")


@pytest.mark.parametrize("method,path,body", [
    ("OPTIONS", "/post", None), ("OPTIONS", "/anything/at/all", None),
    ("GET", "/health", None), ("POST", "/post", {"execEndpoint": "/echo", "data": []}),
    ("POST", "/post", b"{bad"), ("GET", "/nowhere", None)])
def test_cors_as_jax(servers, method, path, body):
    """``cors=True``: any OPTIONS is a 204 preflight with the three
    allow-all headers, which also ride on every routed answer; an unknown
    path is a 405 that allows OPTIONS (the preflight route takes every
    path), without them."""
    def ask(port):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        data = body if body is None or isinstance(body, bytes) else json.dumps(body).encode()
        conn.request(method, path, body=data, headers={"Origin": "http://example"})
        r = conn.getresponse()
        r.read()
        conn.close()
        return r.status, {h: r.getheader(h) for h in CORS + ("Allow",)}

    got, want = ask(servers.cors.port), ask(servers.jcors.port)
    assert got == want
    if method == "OPTIONS":
        assert got == (204, {**dict.fromkeys(CORS, "*"), "Allow": None})
