"""The port's serving plane against the JAX package's: the decorators and
``BaseExecutor`` dispatch, ``WorkerRequestHandler.process_data``, the
standard-library HTTP server against the JAX aiohttp server route by
route, and a spawned ``Pod("worker", protocol="http")`` of each package
serving ``TextExtractionExecutorMock``.

Both sides get the same seeded echo executor (one class body, built on
each package's ``BaseExecutor`` and decorators).  Responses are compared
with request ids, route times and exception stacks masked: those differ
by run (ids, times) or by package (the stack's file paths)."""

import asyncio
import http.client
import json
import threading
import time

import numpy as np
import pytest

from marie_tpu.serve.executors import BaseExecutor as JBaseExecutor
from marie_tpu.serve.executors import decorators as jdec
from marie_tpu.serve.runtimes.servers.http_server import HTTPServer as JHTTPServer
from marie_tpu.serve.runtimes.worker.request_handling import (
    WorkerRequestHandler as JWorkerRequestHandler,
)
from marie_tpu.types.docs import Document as JDocument
from marie_tpu.types.docs import DocumentArray as JDocumentArray
from marie_tpu.types.request import DataRequest as JDataRequest
from marie_tpu.types.request import ts_iso as jts_iso
from marie_tpu_torch.serve.executors import BaseExecutor
from marie_tpu_torch.serve.executors import decorators as tdec
from marie_tpu_torch.serve.runtimes.servers.http_server import HTTPServer
from marie_tpu_torch.serve.runtimes.worker.request_handling import WorkerRequestHandler
from marie_tpu_torch.types.docs import Document, DocumentArray
from marie_tpu_torch.types.request import DataRequest

SEED = 17


def _echo_class(base, dec):
    """The test executor on one package's base class and decorators."""

    class Echo(base):
        @dec.requests(on="/echo")
        def echo(self, docs, parameters, **kwargs):
            for d in docs:
                d.text = f"echo:{d.text}:{parameters.get('suffix', '')}"
            return docs

        @dec.requests(on="/aecho")
        async def aecho(self, docs, **kwargs):
            for d in docs:
                d.tags["async"] = True
            return docs

        @dec.requests(on="/stats")
        @dec.safely_encoded
        def stats(self, docs, parameters, **kwargs):
            rng = np.random.default_rng(SEED)
            return {"n": len(docs), "draw": rng.standard_normal(3).astype(np.float32),
                    "ints": np.arange(3, dtype=np.int64), "raw": b"\x01\x02",
                    "scale": np.float64(parameters.get("scale", 1.0))}

        @dec.requests(on="/boom")
        def boom(self, docs, **kwargs):
            raise RuntimeError("intentional failure", 7)

        @dec.requests(on="/stream")
        def stream(self, docs, **kwargs):
            for d in docs:
                for i in range(2):
                    yield type(d)(id=f"{d.id}-{i}", text=f"{d.text}/{i}")

        @dec.requests(on="/astream")
        async def astream(self, docs, **kwargs):
            for d in docs:
                yield type(d)(id=f"{d.id}-a", text=d.text)

        @dec.requests(on="/batch")
        @dec.dynamic_batching(preferred_batch_size=4, timeout=200)
        def batch(self, docs, **kwargs):
            for d in docs:
                d.tags["batch"] = len(docs)
            return docs

        @dec.requests(on="/write")
        @dec.write
        def write_ep(self, docs, **kwargs):
            return docs

        @dec.requests(on="/slow")
        def slow(self, docs, **kwargs):
            time.sleep(0.6)
            return docs

    return Echo


JEcho = _echo_class(JBaseExecutor, jdec)
TEcho = _echo_class(BaseExecutor, tdec)


def _docs(cls, n=3):
    rng = np.random.default_rng(SEED)
    return [cls(id=f"d{i}", text=f"t{i}", tags={"k": i},
                tensor=rng.integers(0, 255, (2, 3), dtype=np.uint8)) for i in range(n)]


def _run(coro):
    return asyncio.run(coro)


def test_decorators_and_dispatch_match_jax():
    """Endpoints, write endpoints, batching settings, the generator flags,
    sync/async dispatch, a generator's items and the missing-endpoint
    error are the JAX executor's."""
    j, t = JEcho(), TEcho()
    assert sorted(t.requests) == sorted(j.requests)
    assert t.write_endpoints == j.write_endpoints == ["/write"]
    assert t.dynamic_batching == j.dynamic_batching
    for ep in sorted(j.requests):
        assert t.is_generator_endpoint(ep) == j.is_generator_endpoint(ep), ep

    async def both(ep, params):
        jd = await j.__acall__(ep, JDocumentArray(_docs(JDocument)), params)
        td = await t.__acall__(ep, DocumentArray(_docs(Document)), params)
        return jd, td

    for ep in ("/echo", "/aecho", "/batch"):
        jd, td = _run(both(ep, {"suffix": "s"}))
        assert td.to_json() == jd.to_json(), ep
    jd, td = _run(both("/stats", {"scale": 2}))
    assert json.dumps(td) == json.dumps(jd)

    async def stream(ex, cls, ep):
        return [d.to_json() async for d in ex.__acall_stream__(ep, _docs(cls), {})]

    for ep in ("/stream", "/astream"):
        assert _run(stream(t, Document, ep)) == _run(stream(j, JDocument, ep))
    with pytest.raises(ValueError) as te:
        _run(t.__acall__("/nope", [], {}))
    with pytest.raises(ValueError) as je:
        _run(j.__acall__("/nope", [], {}))
    assert str(te.value) == str(je.value)
    assert t.endpoint_for("/nope") is None
    assert tdec._jsonify({"a": (np.int32(1), np.float32(0.5), b"x")}) == \
        jdec._jsonify({"a": (np.int32(1), np.float32(0.5), b"x")})


def _response(resp, jax_side: bool):
    """A handler response as comparable data (ids, times and stacks out)."""
    st = resp.status
    exc = st.exception
    status = (int(st.code), st.description, exc.name, list(exc.args), exc.executor)
    routes = [(r.executor, bool(jts_iso(r.start_time) if jax_side else r.start_time))
              for r in resp.routes]
    return (resp.exec_endpoint, resp.docs.to_json(), json.dumps(resp.parameters), status,
            routes)


def test_process_data_matches_jax(tmp_path):
    """process_data on the same requests: docs, parameters (with the
    ``__results__`` of a dict result and executor-specific overrides),
    status, routes; target and endpoint mismatches pass the docs through;
    a generator endpoint is refused; two concurrent requests of a
    dynamic-batching endpoint merge into one batch; the job records land
    in the sqlite KV; the single-doc stream."""
    jh = JWorkerRequestHandler(uses=JEcho, name="echo", job_kv_path=str(tmp_path / "j.db"))
    th = WorkerRequestHandler(uses=TEcho, name="echo", job_kv_path=str(tmp_path / "t.db"))
    cases = [("/echo", {"suffix": "x", "echo": {"suffix": "y"}}, ""),
             ("/stats", {"scale": 3, "job_id": "job-1"}, ""),
             ("/boom", {"job_id": "job-2"}, ""),
             ("/echo", {}, "other"),
             ("/unknown", {}, ""),
             ("/stream", {}, "")]

    async def run(handler, req_cls, doc_cls, arr_cls):
        out = []
        for ep, params, target in cases:
            req = req_cls.from_docs(arr_cls(_docs(doc_cls)), endpoint=ep, parameters=params,
                                    target_executor=target)
            out.append(await handler.process_data([req]))
        reqs = [req_cls.from_docs(arr_cls(_docs(doc_cls, 2)), endpoint="/batch")
                for _ in range(2)]
        out += await asyncio.gather(*(handler.process_data([r]) for r in reqs))
        streamed = [d.to_json() async for d in handler.process_single_doc_stream(
            req_cls.from_docs(arr_cls(_docs(doc_cls, 1)), endpoint="/stream"))]
        await handler.close()
        return out, streamed

    jout, jstream = _run(run(jh, JDataRequest, JDocument, JDocumentArray))
    tout, tstream = _run(run(th, DataRequest, Document, DocumentArray))
    for (ep, _, _), j, t in zip(cases + [("/batch",) * 3] * 2, jout, tout):
        assert _response(t, False) == _response(j, True), ep
    assert json.loads(tout[-1].docs.to_json())[0]["tags"]["batch"] == 4
    assert tstream == jstream and len(tstream) == 2
    assert th.endpoints() == jh.endpoints()

    async def records(handler):
        kv = handler._job_kv
        keys = await kv.internal_kv_keys("job/", namespace="worker_jobs")
        return {k: json.loads(await kv.internal_kv_get(k, namespace="worker_jobs"))["state"]
                for k in keys}

    assert _run(records(th)) == _run(records(jh)) == {
        "job/job-1/worker/echo": "successful", "job/job-2/worker/echo": "failed"}
    with pytest.raises(NotImplementedError, match="item 3.4"):
        WorkerRequestHandler(uses="conf/executor.yml")
    with pytest.raises(NotImplementedError, match="item 10"):
        WorkerRequestHandler(uses="hub://some/executor")


class _Loop:
    """An asyncio loop on a thread, and the HTTP servers started on it."""

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


@pytest.fixture(scope="module")
def servers():
    """The JAX aiohttp server and the port's server, each over its own
    package's handler of the echo executor, on one loop."""
    s = _Loop()
    s.jax = s.serve(JHTTPServer(JWorkerRequestHandler(uses=JEcho, name="echo"), name="t"))
    s.port = s.serve(HTTPServer(WorkerRequestHandler(uses=TEcho, name="echo"), name="t"))
    yield s
    s.close()


def _ask(port, method, path, body=None, headers=None, conn=None):
    """(status, content type, body bytes) of one request."""
    own = conn is None
    conn = conn or http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    data = None if body is None else (body if isinstance(body, bytes)
                                      else json.dumps(body).encode())
    conn.request(method, path, body=data, headers=headers or {})
    resp = conn.getresponse()
    out = (resp.status, resp.getheader("Content-Type"), resp.read())
    if own:
        conn.close()
    return out


def _masked(raw: bytes):
    """A /post body with the request id, route times and stacks masked."""
    body = json.loads(raw)
    if isinstance(body, dict) and "header" in body:
        body["header"]["requestId"] = "*"
        body["header"]["status"].get("exception", {}).pop("stacks", None)
        for r in body["routes"]:
            r["startTime"] = r["endTime"] = "*"
    return body


def _post(ep, params=None, n=2):
    return {"execEndpoint": ep, "data": [d.to_dict() for d in _docs(Document, n)],
            "parameters": params or {}, "targetExecutor": ""}


ROUTES = [
    ("GET", "/", None), ("GET", "/health", None), ("GET", "/dry_run", None),
    ("GET", "/endpoints", None), ("GET", "/openapi.json", None),
    ("POST", "/post", _post("/echo", {"suffix": "q"})),
    ("POST", "/post", _post("/stats", {"scale": 5})),
    ("POST", "/post", _post("/boom")),
    ("POST", "/post", _post("/stream")),
    ("POST", "/post", _post("/missing")),
    ("POST", "/post", {"execEndpoint": "/echo"}),
    ("POST", "/post", b"{not json"),
    ("POST", "/post_stream", _post("/stream", n=2)),
    ("POST", "/post_stream", _post("/echo", n=1)),
    ("POST", "/post_stream", b"[oops"),
    ("GET", "/nowhere", None),
    ("GET", "/post", None),
]


@pytest.mark.parametrize("method,path,body", ROUTES, ids=[f"{m} {p} {i}" for i, (m, p, _)
                                                          in enumerate(ROUTES)])
def test_http_routes_match_jax(servers, method, path, body):
    got = _ask(servers.port.port, method, path, body)
    want = _ask(servers.jax.port, method, path, body)
    assert got[0] == want[0]
    assert got[1].split(";")[0] == want[1].split(";")[0]
    if path == "/post_stream" and got[0] == 200:
        assert got[2] == want[2] and got[2].count(b"\n") >= 1
    elif want[1].startswith("application/json"):
        assert _masked(got[2]) == _masked(want[2])
    else:
        assert got[2] == want[2]


def test_http_status_metrics_and_keep_alive(servers):
    """/status carries each package's version table, /metrics the
    request metrics, HEAD answers a GET route without its body; two
    requests share one keep-alive connection."""
    st, _, raw = _ask(servers.port.port, "GET", "/status")
    jst, _, jraw = _ask(servers.jax.port, "GET", "/status")
    assert st == jst == 200 and set(json.loads(raw)) == set(json.loads(jraw)) == {"jina", "envs"}
    assert "torch" in json.loads(raw)["jina"]
    _ask(servers.port.port, "POST", "/post", _post("/echo"))
    st, ctype, text = _ask(servers.port.port, "GET", "/metrics")
    assert st == 200 and ctype.startswith("text/plain")
    assert b'marie_request_seconds_count{executor="echo",runtime="worker"}' in text
    heads = [_ask(port, "HEAD", "/health") for port in (servers.port.port, servers.jax.port)]
    assert heads[0][0] == heads[1][0] == 200 and heads[0][2] == heads[1][2] == b""
    conn = http.client.HTTPConnection("127.0.0.1", servers.port.port, timeout=60)
    a = _ask(None, "POST", "/post", _post("/echo"), conn=conn)
    sock = conn.sock
    b = _ask(None, "GET", "/health", conn=conn)
    assert conn.sock is sock and a[0] == b[0] == 200
    conn.close()


def test_metrics_carry_kernel_launches(servers, monkeypatch):
    """/metrics ends with the kernels' launches in the server's process,
    by kernel and engine path (none before a kernel launched)."""
    from marie_tpu_torch.ops.kernels import _build

    monkeypatch.setattr(_build, "_COUNTED", {})
    assert b"marie_kernel_launches_total" not in _ask(servers.port.port, "GET", "/metrics")[2]

    def crop_resize():
        pass

    crop_resize.launches, crop_resize.launches_by_path = 0, {}
    with _build.launch_path("fused"):
        _build.count_launch(crop_resize)
        _build.count_launch(crop_resize)
    _build.count_launch(crop_resize)
    text = _ask(servers.port.port, "GET", "/metrics")[2].decode()
    assert text.endswith('# TYPE marie_kernel_launches_total counter\n'
                         'marie_kernel_launches_total{kernel="crop_resize",path="fused"} 2\n'
                         'marie_kernel_launches_total{kernel="crop_resize",path="other"} 1\n')


def test_client_timeout_is_per_request(servers):
    """A short timeout on one request does not stay on the kept
    connection: the next request, without a timeout, waits for a slow
    endpoint; one with a shorter timeout than the endpoint times out."""
    from marie_tpu_torch.clients import HTTPClient

    client = HTTPClient(port=servers.port.port)
    try:
        assert client.get("/health", timeout=0.2) == (200, {"status": "OK"})
        docs = client.post("/slow", [Document(id="s", text="x")])
        assert [d.id for d in docs] == ["s"]
        with pytest.raises(TimeoutError):
            client.post("/slow", [Document(id="s")], timeout=0.2)
    finally:
        client.close()


def test_http_auth_and_body_limit(servers, monkeypatch):
    """With API keys set, a route needs the Bearer key (401 without, as
    JAX's) while the probes stay open; a body over 64 MiB gets 413."""
    from marie_tpu.auth import APIKeyManager as JKeys
    from marie_tpu_torch.auth import APIKeyManager as TKeys

    monkeypatch.setattr(JKeys, "_keys", {})
    monkeypatch.setattr(TKeys, "_keys", {})
    TKeys.from_config([{"name": "n", "api_key": "mas_k"}])
    JKeys.from_config([{"name": "n", "api_key": "mas_k"}])
    for port in (servers.port.port, servers.jax.port):
        assert _ask(port, "GET", "/health")[0] == 200
    for path, body in (("/post", _post("/echo")), ("/endpoints", None)):
        method = "POST" if body else "GET"
        got = _ask(servers.port.port, method, path, body)
        want = _ask(servers.jax.port, method, path, body)
        assert got[0] == want[0] == 401 and json.loads(got[2]) == json.loads(want[2])
        ok = _ask(servers.port.port, method, path, body, {"Authorization": "Bearer mas_k"})
        assert ok[0] == 200
    monkeypatch.setattr(TKeys, "_keys", {})
    monkeypatch.setattr(JKeys, "_keys", {})
    big = b" " * (64 * 1024 * 1024 + 1)
    got = _ask(servers.port.port, "POST", "/post", big)
    want = _ask(servers.jax.port, "POST", "/post", big)
    assert got[0] == want[0] == 413
    assert got[2].startswith(b"Maximum request body size 67108864 exceeded")


def _raw_head_answer(port, head: bytes, body: bytes = b""):
    """Send a request head (and the start of its body) on a raw socket and
    read the answer to its end without sending the rest of the body: the
    answer must come before the body is read."""
    import socket

    with socket.create_connection(("127.0.0.1", port), timeout=5) as s:
        s.sendall(head + body)
        s.shutdown(socket.SHUT_WR)
        out = b""
        while chunk := s.recv(1 << 16):
            out += chunk
    return out


def test_http_refuses_before_reading_the_body(servers, monkeypatch):
    """A 401 and a 413 by Content-Length go out on the request's head:
    the server neither waits for nor keeps the declared 64 MiB, answers,
    drops what arrives and closes."""
    from marie_tpu_torch.auth import APIKeyManager as TKeys

    port = servers.port.port
    monkeypatch.setattr(TKeys, "_keys", {})
    TKeys.from_config([{"name": "n", "api_key": "mas_k"}])
    head = b"POST /post HTTP/1.1\r\nHost: x\r\nContent-Length: 67108864\r\n\r\n"
    out = _raw_head_answer(port, head, b"{" * 4096)
    assert out.startswith(b"HTTP/1.1 401 ") and b"Connection: close" in out
    assert out.endswith(b'{"error": "missing or invalid API key"}')
    monkeypatch.setattr(TKeys, "_keys", {})
    head = b"POST /post HTTP/1.1\r\nHost: x\r\nContent-Length: 67108865\r\n\r\n"
    out = _raw_head_answer(port, head)
    assert out.startswith(b"HTTP/1.1 413 ") and b"Connection: close" in out
    assert out.endswith(b"Maximum request body size 67108864 exceeded, actual body size "
                        b"67108865")
    # a refused request without a body keeps its connection
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    TKeys.from_config([{"name": "n", "api_key": "mas_k"}])
    assert _ask(None, "GET", "/endpoints", conn=conn)[0] == 401
    sock = conn.sock
    assert _ask(None, "GET", "/health", conn=conn)[0] == 200 and conn.sock is sock
    conn.close()


def test_pods_serve_the_mock_executor_like_jax():
    """A spawned worker pod of each package serves
    ``TextExtractionExecutorMock`` over HTTP: two requests (a page tensor,
    then no documents) answer equal envelopes; the pods close and free
    their ports."""
    import socket

    from marie_tpu.orchestrate.pods import Pod as JPod
    from marie_tpu_torch.clients import HTTPClient
    from marie_tpu_torch.orchestrate.pods import Pod

    page = np.full((48, 64), 255, np.uint8)
    page[10:20, 8:40] = 0
    bodies = {}
    for side, pod in (("port", Pod("worker", uses="marie_tpu_torch.executor."
                                   "TextExtractionExecutorMock", protocol="http",
                                   name="mock")),
                      ("jax", JPod("worker", uses="marie_tpu.executor."
                                   "TextExtractionExecutorMock", protocol="http",
                                   name="mock"))):
        with pod:
            client = HTTPClient(port=pod.port)
            bodies[side] = [
                client.post("/document/extract", [Document(id="p", tensor=page)],
                            parameters={"ref_id": "r"}, return_responses=True),
                client.post("/document/extract", [], return_responses=True)]
            client.close()
            port = pod.port
        assert not pod.is_alive()
        with socket.socket() as s:
            s.bind(("127.0.0.1", port))  # the port is free again
    for got, want in zip(bodies["port"], bodies["jax"]):
        assert _masked(json.dumps(got).encode()) == _masked(json.dumps(want).encode())
    result = bodies["port"][0]["parameters"]["__results__"]["mock"]
    assert result["status"] == "succeeded" and result["runtime_info"]["pages"] == 1


def test_concurrent_extract_requests_equal_sequential(tmp_path):
    """Six ``/document/extract`` requests in flight at once on one served
    ``TextExtractionExecutor`` (tiny float32 models, ink boxes, the CPU)
    answer what the same requests answer one at a time: the engine's
    shared worker threads, precision context and launch paths keep
    concurrent calls apart.  The interpreter switches threads every 10 us
    meanwhile, to shake out lost updates."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    from marie_tpu_torch.boxes.craft_box_processor import BoxProcessorCraft
    from marie_tpu_torch.clients import HTTPClient
    from marie_tpu_torch.document.trocr_ocr_processor import TrOcrProcessor
    from marie_tpu_torch.executor import TextExtractionExecutor
    from marie_tpu_torch.models.configs import CraftConfig, TrOCRConfig
    from marie_tpu_torch.ocr.ocr_engine import PipelineOcrEngine
    from marie_tpu_torch.pipe import ExtractPipeline
    from marie_tpu_torch.preprocess.buckets import BucketSpec
    from marie_tpu_torch.registry.convert import init_flax_layout
    from tests.test_torch_engine import _page

    bp = BoxProcessorCraft(CraftConfig.tiny(), init_flax_layout(CraftConfig.tiny(), 7),
                           box_source="ink", max_components=64, device="cpu",
                           bucket_spec=BucketSpec(shapes=((256, 384),)))
    op = TrOcrProcessor(TrOCRConfig.tiny(), init_flax_layout(TrOCRConfig.tiny(), 8),
                        batch_sizes=(8, 32), decode_steps=8, device="cpu")
    engine = PipelineOcrEngine(bp, op, page_fuse_batch=2, compact_slots=4)
    executor = TextExtractionExecutor(
        pipeline=ExtractPipeline(ocr_engine=engine, work_dir=str(tmp_path), device="cpu"))
    loop = _Loop()
    server = loop.serve(HTTPServer(WorkerRequestHandler(executor=executor, name="x")))
    requests = [[_page(10 + 2 * i, n_words=5), _page(11 + 2 * i, n_words=4)]
                for i in range(6)]

    def ask(i):
        client = HTTPClient(port=server.port)
        try:
            body = client.post("/document/extract",
                               [Document(id=f"r{i}-{k}", tensor=p)
                                for k, p in enumerate(requests[i])],
                               parameters={"ref_id": f"r{i}"}, return_responses=True)
        finally:
            client.close()
        env = body["parameters"]["__results__"]["x"]
        assert env["status"] == "succeeded", env
        return [[(w["text"], w["box"]) for w in page["words"]] for page in env["metadata"]["ocr"]]

    interval = sys.getswitchinterval()
    try:
        sequential = [ask(i) for i in range(6)]
        sys.setswitchinterval(1e-5)
        with ThreadPoolExecutor(6) as pool:
            concurrent = list(pool.map(ask, range(6), timeout=300))
    finally:
        sys.setswitchinterval(interval)
        loop.close()
    assert concurrent == sequential
    assert sum(len(page) for req in sequential for page in req) >= 20
