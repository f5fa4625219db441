"""The server shell (counterpart of ``marie_tpu_server/__init__.py``): boots
a Flow from YAML and binds the job and REST control plane around it.

``run_server(uses=<yml>)`` loads the environment file, builds the
hand-written kernels before the Flow spawns its workers
(:func:`marie_tpu_torch.utils.kernel_cache.enable_persistent_cache`), loads
the YAML's ``auth.keys``, loads the YAML into a :class:`Flow` (JAML, with
the environment as context), starts it (each worker warms its programs
before it serves, ``utils/program_zoo.py``) and serves
:func:`_run_control_plane` until SIGINT or SIGTERM, then closes the Flow.

The control plane serves the JAX server's routes on the port's HTTP/1.1
server (``serve/runtimes/servers/http_server.py``; aiohttp is not on the
card's machine), with the same status codes and JSON bodies:
``POST /api/jobs/submit``, ``GET /api/jobs``, ``GET /api/jobs/{job_id}``,
``POST /api/jobs/{job_id}/stop``, ``DELETE /api/jobs/{job_id}``,
``POST|GET /api/schedules``, ``DELETE /api/schedules/{name}``,
``GET /api/events`` (server-sent events of Toast), ``GET /api/nodes``, the
forwarders ``POST /api/document/extract``, ``/api/ner/extract``,
``/api/document/classify`` and ``/api/overlay`` (through the port's gRPC
client to the Flow's gateway), the status probes, ``/health/status`` and
``/metrics``.  With API keys configured every route but the probes needs
``Authorization: Bearer <key>``.  ``/metrics`` adds, to the process's
registry, the kernels' launches in the Flow's workers (each worker's
``_status``): the requests' as ``marie_kernel_launches_total`` and the
warm-ups' apart; ``marie_kernel_build_seconds`` is the wall time of the
kernels' build before the Flow (0 when every library was built).

State (the jobs' KV, the scheduler's database, the events file) lives in
``default_state_dir()``: ``marie/`` under the temporary directory.
"""

import asyncio
import json
import os
import signal
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional

from marie_tpu_torch.logging_core import MarieLogger

logger = MarieLogger("server")


def default_state_dir() -> str:
    """``marie/`` under the temporary directory (``TMPDIR``)."""
    return os.path.join(tempfile.gettempdir(), "marie")


def load_env_file(path: Optional[str]) -> None:
    """``KEY=value`` lines of ``path`` into the environment (set keys win)."""
    if not path or not os.path.exists(path):
        return
    with open(path) as fp:
        for line in fp:
            line = line.strip()
            if line and not line.startswith("#") and "=" in line:
                k, _, v = line.partition("=")
                os.environ.setdefault(k.strip(), v.strip())


def _raise_interrupt(signum, frame):
    raise KeyboardInterrupt


def run_server(uses: Optional[str] = None, port: Optional[int] = None,
               protocols: Optional[List[str]] = None, env_file: Optional[str] = None,
               device: str = "cuda", rest_port: Optional[int] = None) -> int:
    """``server --start --uses config.yml``: serve until SIGINT or SIGTERM.

    ``device="cuda"`` (the default) needs the card: the kernels build
    before the Flow starts; ``"cpu"`` skips the build (the executors'
    devices come from their YAML).  ``rest_port`` is the control plane's
    port (a free one when None).  State (the job KV, the scheduler's and
    the events' databases) lives in ``default_state_dir()``."""
    from marie_tpu_torch.helper import random_port
    from marie_tpu_torch.orchestrate.flow import Flow

    load_env_file(env_file)
    state_dir = default_state_dir()
    os.makedirs(state_dir, exist_ok=True)
    # workers record each job's start, failure and success in this KV
    os.environ.setdefault("MARIE_JOB_KV", os.path.join(state_dir, "kv.db"))

    if device != "cpu":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError(f"run_server(device={device!r}) needs a CUDA device; pass "
                               f"device='cpu' to serve without one")
        from marie_tpu_torch.metrics import MetricUnit, get_registry
        from marie_tpu_torch.utils.kernel_cache import enable_persistent_cache

        t0 = time.perf_counter()
        built = enable_persistent_cache()
        get_registry().metric("kernel_build_seconds", MetricUnit.SECONDS).record(
            time.perf_counter() - t0 if built else 0.0)
        logger.info(f"kernels built before the flow: {built or 'all cached'}")

    if uses:
        _setup_auth(uses)
        flow = Flow.load_config(uses, context=dict(os.environ))
    else:  # the control plane alone, over a flow of the base executor
        from marie_tpu_torch.serve.executors import BaseExecutor

        flow = Flow().add(uses=BaseExecutor, name="noop")
    if port:
        flow.port = port
    if protocols:
        flow.protocols = list(protocols)

    rest_port = rest_port or random_port()
    previous = None
    if threading.current_thread() is threading.main_thread():
        previous = signal.signal(signal.SIGTERM, _raise_interrupt)
    try:
        with flow:
            logger.info(f"flow gateway at {flow.gateway_address}")
            try:
                asyncio.run(_run_control_plane(flow, rest_port, state_dir=state_dir))
            except KeyboardInterrupt:
                pass
    except KeyboardInterrupt:
        pass
    finally:
        if previous is not None:
            signal.signal(signal.SIGTERM, previous)
    return 0


def _setup_auth(config_path: str) -> None:
    """API keys from the server YAML's ``auth.keys``; once keys exist,
    every server of this process asks for a Bearer key."""
    try:
        from marie_tpu_torch.auth import APIKeyManager
        from marie_tpu_torch.jaml import JAML

        conf = JAML.load_config(config_path, context=dict(os.environ))
        keys = (conf.get("auth") or {}).get("keys") if isinstance(conf, dict) else None
        if keys:
            APIKeyManager.from_config(keys)
            logger.info(f"auth enabled with {len(keys)} configured key(s)")
    except Exception as ex:  # noqa: BLE001
        logger.warning(f"auth config not loaded: {ex!r}")


def _service_key() -> Optional[str]:
    """A configured, enabled key for the control plane's own calls."""
    from marie_tpu_torch.auth import APIKeyManager

    for key, info in APIKeyManager._keys.items():
        if info.get("enabled"):
            return key
    return None


def _sum_launches(into: Dict[str, Dict[str, int]], counts: Dict[str, Dict[str, int]]) -> None:
    for kernel, paths in (counts or {}).items():
        for path, n in paths.items():
            into.setdefault(kernel, {})[path] = into.get(kernel, {}).get(path, 0) + int(n)


async def _run_control_plane(flow, rest_port: int, state_dir: Optional[str] = None) -> None:
    """The REST job API and the scheduler, bound to the running flow,
    until cancelled."""
    from marie_tpu_torch.api.payload import parse_payload_to_frames
    from marie_tpu_torch.clients import Client
    from marie_tpu_torch.clients.grpc_client import GRPCClient
    from marie_tpu_torch.enums import JobStatus
    from marie_tpu_torch.helper import default_bind_host
    from marie_tpu_torch.job.job_manager import JobManager
    from marie_tpu_torch.messaging import Toast
    from marie_tpu_torch.messaging.native_handler import NativeToastHandler
    from marie_tpu_torch.metrics.prometheus import (
        render_launches, render_prometheus, render_warmup)
    from marie_tpu_torch.scheduler.models import WorkInfo
    from marie_tpu_torch.scheduler.sql import SqlJobScheduler
    from marie_tpu_torch.serve.runtimes.servers.http_server import (
        HTTPServer, StreamResponse, json_response, text_response)
    from marie_tpu_torch.storage.kv.sqlite_kv import SqliteKV
    from marie_tpu_torch.types.docs import Document, DocumentArray

    state_dir = state_dir or default_state_dir()
    os.makedirs(state_dir, exist_ok=True)
    native = NativeToastHandler(os.path.join(state_dir, "events.jsonl"))
    Toast.register(native, native=True)

    kv = SqliteKV(os.path.join(state_dir, "kv.db"))
    client = Client(port=flow.port_gateway, api_key=_service_key())

    async def distributor(job_id: str, info):
        meta = info.metadata or {}
        docs = DocumentArray([Document(tags={"job_id": job_id, **meta.get("doc_tags", {})})])
        return {"docs": len(await client.apost(
            on=info.entrypoint or "/default", inputs=docs,
            parameters={"job_id": job_id, **meta.get("parameters", {})}))}

    job_manager = JobManager(kv, job_distributor=distributor)

    async def scheduler_handler(work: WorkInfo) -> bool:
        job_id = await job_manager.submit_job(entrypoint=work.data.get("entrypoint", "/default"),
                                              metadata=work.data.get("metadata", {}))
        while True:  # until the job is terminal
            status = await job_manager.get_job_status(job_id)
            if status.is_terminal:
                return status == JobStatus.SUCCEEDED
            await asyncio.sleep(0.25)

    scheduler = SqlJobScheduler(os.path.join(state_dir, "scheduler.db"),
                                job_handler=scheduler_handler)
    await scheduler.start()

    def bad_json():
        return json_response({"error": "invalid JSON body"}, status=400)

    async def submit(request):
        try:
            body = request.json()
        except ValueError:
            return bad_json()
        work = WorkInfo(
            name=body.get("queue", "default"),
            data={"entrypoint": body.get("entrypoint", "/default"),
                  "metadata": body.get("metadata", {})},
            priority=int(body.get("priority", 0)),
            retry_limit=int(body.get("retry_limit", 2)),
            dead_letter=body.get("dead_letter"),
            keep_until=float(body.get("keep_until", 0.0)))
        job_id = await scheduler.submit_job(work)
        return json_response({"jobid": job_id, "status": "ok"})

    async def list_jobs(request):
        jobs = await scheduler.list_jobs()
        return json_response({"jobs": [w.model_dump(mode="json") for w in jobs]})

    async def job_info(request):
        job_id = request.match_info["job_id"]
        work = await scheduler.get_job(job_id)
        if work is None:
            return json_response({"error": "not found"}, status=404)
        payload = work.model_dump(mode="json")
        try:  # the workers' own records of the job
            keys = await kv.internal_kv_keys(f"job/{job_id}/worker/", namespace="worker_jobs")
            workers = {}
            for k in keys:
                raw = await kv.internal_kv_get(k, namespace="worker_jobs")
                if raw:
                    workers[k.rsplit("/", 1)[-1]] = json.loads(raw)
            if workers:
                payload["workers"] = workers
        except Exception:  # noqa: BLE001 — the records are best-effort
            pass
        return json_response(payload)

    async def stop_job(request):
        return json_response({"stopped": await scheduler.cancel_job(request.match_info["job_id"])})

    async def delete_job(request):
        return json_response({"deleted": await scheduler.cancel_job(request.match_info["job_id"])})

    async def health(request):
        return json_response({"status": "OK"})

    async def worker_reports() -> List[Dict[str, Any]]:
        """Each worker pod's ``_status`` (its launches and warm-up)."""
        out = []
        for dep in flow._deployments.values():
            for pod in dep.pods:
                c = GRPCClient(port=pod.port, api_key=_service_key())
                try:
                    out.append(await c.ainfo(timeout=10.0))
                except Exception as ex:  # noqa: BLE001 — a worker that does not answer
                    logger.warning(f"no status from {pod.name}: {ex!r}")
                finally:
                    await c.aclose()
        return out

    async def metrics(request):
        launches: Dict[str, Dict[str, int]] = {}
        # the workers' warm-ups summed into one report
        warm: Dict[str, Any] = {"seconds": 0.0, "launches": {}, "parts": []}
        for info in await worker_reports():
            _sum_launches(launches, info.get("kernel_launches"))
            report = info.get("warmup") or {}
            _sum_launches(warm["launches"], report.get("launches"))
            if report.get("parts"):
                warm["seconds"] += float(report.get("seconds", 0.0))
                warm["parts"] += list(report["parts"])
        return text_response(render_prometheus() + render_launches(launches)
                             + render_warmup(warm))

    subscribers: List[asyncio.Queue] = []

    class _SSEToast:
        def notify(self, event, notification, **kw):
            for q in list(subscribers):
                q.put_nowait({"event": event, **notification})

    sse = _SSEToast()
    Toast.register(sse)

    async def events_stream(request):
        q: asyncio.Queue = asyncio.Queue()
        subscribers.append(q)

        async def chunks():
            try:
                while True:
                    ev = await q.get()
                    yield (f"event: {ev.get('event', 'message')}\n"
                           f"data: {json.dumps(ev)}\n\n").encode()
            finally:
                subscribers.remove(q)

        return StreamResponse(chunks(), headers={"Cache-Control": "no-cache"})

    async def nodes(request):
        return json_response({"gateway": f"127.0.0.1:{flow.port_gateway}",
                              "deployments": {name: dep.addresses
                                              for name, dep in flow._deployments.items()}})

    def make_document_forwarder(flow_endpoint: str):
        """A REST facade that forwards into a flow endpoint."""

        async def forwarder(request):
            try:
                body = request.json()
            except ValueError:
                return bad_json()
            doc = Document(tags={})
            if body.get("uri") and not body.get("data"):
                doc.uri = body["uri"]  # the executor resolves it
            else:
                try:
                    frames, checksum, _ = parse_payload_to_frames(body,
                                                                  body.get("queue_id", "api"))
                except (ValueError, FileNotFoundError) as ex:
                    return json_response(
                        {"error": str(ex) or "request needs 'data' (base64) or 'uri'"},
                        status=400)
                doc.tensor = frames[0]
                doc.tags["checksum"] = checksum
                doc.tags["pages"] = len(frames)
            params = {"mode": body.get("mode", "sparse"),
                      "output_format": body.get("output_format", "xywh"),
                      "features": body.get("features", {})}
            for key in ("doc_id", "doc_type", "regions"):
                if body.get(key):
                    params[key] = body[key]
            try:
                resp = await client.apost(on=flow_endpoint, inputs=DocumentArray([doc]),
                                          parameters=params, return_responses=True)
            except Exception as ex:  # noqa: BLE001
                return json_response({"status": "failed", "error": repr(ex)}, status=500)
            results = resp.parameters.get("__results__", {})
            payload = next(iter(results.values()), {}) if results else {}
            if not payload and len(resp.docs):
                payload = {"status": "succeeded", "docs": resp.docs.to_dict()}
            return json_response(payload if payload else {"status": "succeeded"})

        return forwarder

    async def capability_status(request):
        return json_response({"status": "OK"})

    async def schedule_put(request):
        try:
            body = request.json()
        except ValueError:
            return bad_json()
        try:
            scheduler.schedule(body["queue"], body["cron"], data=body.get("data") or {})
        except (KeyError, ValueError) as ex:
            return json_response({"error": repr(ex)}, status=400)
        return json_response({"status": "ok"})

    async def schedule_list(request):
        return json_response({"schedules": scheduler.schedules()})

    async def schedule_delete(request):
        if not scheduler.unschedule(request.match_info["name"]):
            return json_response({"error": "not found"}, status=404)
        return json_response({"status": "ok"})

    routes = [
        ("POST", "/api/document/extract", make_document_forwarder("/document/extract")),
        ("POST", "/api/ner/extract", make_document_forwarder("/ner/extract")),
        ("POST", "/api/document/classify", make_document_forwarder("/document/classify")),
        ("POST", "/api/overlay", make_document_forwarder("/overlay/segment")),
        *(("GET", probe, capability_status)
          for probe in ("/api/document/status", "/api/ner/status", "/api/overlay/status")),
        ("POST", "/api/schedules", schedule_put),
        ("GET", "/api/schedules", schedule_list),
        ("DELETE", "/api/schedules/{name}", schedule_delete),
        ("POST", "/api/jobs/submit", submit),
        ("GET", "/api/jobs", list_jobs),
        ("GET", "/api/jobs/{job_id}", job_info),
        ("POST", "/api/jobs/{job_id}/stop", stop_job),
        ("DELETE", "/api/jobs/{job_id}", delete_job),
        ("GET", "/api/events", events_stream),
        ("GET", "/api/nodes", nodes),
        ("GET", "/health/status", health),
        ("GET", "/metrics", metrics),
    ]
    server = HTTPServer(None, port=rest_port, host=default_bind_host(), name="control-plane",
                        routes=routes)
    await server.setup_server()
    logger.info(f"job REST API at http://127.0.0.1:{server.port}/api/jobs")
    try:
        while True:
            await asyncio.sleep(3600)
    finally:
        await scheduler.stop()
        await server.shutdown()
        await client.aclose()
        Toast.unregister(sse)
        Toast.unregister(native)
