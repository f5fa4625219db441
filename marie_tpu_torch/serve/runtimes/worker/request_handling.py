"""WorkerRequestHandler (port of
``marie_tpu/serve/runtimes/worker/request_handling.py``): loads the
executor and executes requests.

As the JAX handler: endpoint dispatch with executor-specific parameters,
dynamic-batching queues per (endpoint, parameters), the docs reduce of a
request matrix, generator endpoints through
:meth:`process_single_doc_stream`, endpoint discovery, the per-request
metrics and the job records in a sqlite KV (``job_kv_path`` or
``MARIE_JOB_KV``).  The executor comes from a class, a dotted class path
(the JAX package's executor paths map onto the port's), a ``jtype``
mapping, a YAML file or inline YAML (JAML; a file's ``py_modules`` are
imported first, relative to it) or a hub reference (``hub://name[:version]``:
the bundle resolved and installed by :class:`~marie_tpu_torch.hub.ExecutorHub`,
from ``MARIE_HUB_REGISTRY`` when set, then its ``config.yml`` loaded).
``hot_reload=True`` polls the mtime of the executor's source module and,
when it changes, reloads the module and rebuilds the executor; a reload
that fails keeps the old executor serving.  The poll starts on the
running loop at construction, or with :meth:`start_hot_reload`.
"""

import importlib
import json
import os
import re
import time
from datetime import datetime, timezone
from typing import Any, Dict, Optional, Sequence, Type, Union

from marie_tpu_torch.logging_core import MDC, MarieLogger
from marie_tpu_torch.serve.executors import BaseExecutor
from marie_tpu_torch.serve.runtimes.worker.batch_queue import BatchQueue
from marie_tpu_torch.types.docs import DocumentArray
from marie_tpu_torch.types.request import DataRequest


class WorkerRequestHandler:
    def __init__(
        self,
        executor: Optional[BaseExecutor] = None,
        uses: Optional[Union[Type[BaseExecutor], str]] = None,
        uses_with: Optional[Dict[str, Any]] = None,
        name: str = "executor",
        workspace: Optional[str] = None,
        hot_reload: bool = False,
        job_kv_path: Optional[str] = None,
        **kwargs,
    ):
        self.logger = MarieLogger(f"worker/{name}")
        self.name = name
        from marie_tpu_torch.metrics import MetricUnit, get_registry

        reg = get_registry()
        dims = {"runtime": "worker", "executor": name}
        self._m_latency = reg.metric("request_seconds", MetricUnit.SECONDS, dims)
        self._m_docs = reg.metric("request_docs", MetricUnit.COUNT, dims)
        self._m_failed = reg.metric("failed_requests", MetricUnit.COUNT, dims)
        self._m_req_bytes = reg.metric("received_request_bytes", MetricUnit.BYTES, dims)
        self._m_resp_bytes = reg.metric("sent_response_bytes", MetricUnit.BYTES, dims)
        # per-job records in a shared sqlite file, written by the worker so
        # they stay true when a supervisor dies
        self._job_kv = None
        kv_path = job_kv_path or os.environ.get("MARIE_JOB_KV")
        if kv_path:
            try:
                from marie_tpu_torch.storage.kv.sqlite_kv import SqliteKV

                self._job_kv = SqliteKV(kv_path)
            except Exception as ex:  # noqa: BLE001
                self.logger.warning(f"job KV unavailable: {ex!r}")
        self._uses_with, self._workspace = uses_with, workspace
        if executor is not None:
            self._executor = executor
        else:
            self._executor = self._load_executor(uses, uses_with, name, workspace)
        # one BatchQueue per (endpoint, parameters): requests with different
        # parameters never share a merged batch
        self._batch_queue_config: Dict[str, Dict] = {
            ep: dict(cfg) for ep, cfg in self._executor.dynamic_batching.items()}
        self._batch_queues: Dict[str, Dict[str, BatchQueue]] = {
            ep: {} for ep in self._batch_queue_config}
        self._reload_task = None
        if hot_reload:
            import asyncio

            try:
                asyncio.get_running_loop()
            except RuntimeError:
                pass  # no loop yet: the caller starts it (start_hot_reload)
            else:
                self.start_hot_reload()

    def start_hot_reload(self, interval: float = 1.0):
        """Start the source poll on the running loop; returns its task."""
        import asyncio

        if self._reload_task is None:
            self._reload_task = asyncio.get_running_loop().create_task(
                self._hot_reload_loop(interval))
        return self._reload_task

    async def _hot_reload_loop(self, interval: float = 1.0) -> None:
        """Reload the executor when its source module changes on disk (an
        mtime poll)."""
        import asyncio
        import inspect

        module = inspect.getmodule(type(self._executor))
        src = getattr(module, "__file__", None)
        if src is None:
            return
        last = os.path.getmtime(src)
        while True:
            await asyncio.sleep(interval)
            try:
                mtime = os.path.getmtime(src)
            except OSError:
                continue
            if mtime == last:
                continue
            last = mtime
            self.logger.info(f"source change detected in {src}; reloading")
            try:
                importlib.reload(module)
                cls = getattr(module, type(self._executor).__name__)
                self._executor.close()
                self._executor = cls(runtime_args={"name": self.name},
                                     workspace=self._workspace, **(self._uses_with or {}))
            except Exception as ex:  # noqa: BLE001 — the old code keeps serving
                self.logger.error(f"hot reload failed: {ex!r}")

    @staticmethod
    def _load_executor(uses, uses_with, name, workspace) -> BaseExecutor:
        """The executor from a class, a dotted class path
        (``pkg.module.Class``), a ``jtype`` mapping or YAML, built with
        ``uses_with``."""
        from marie_tpu_torch.jaml import JAML, resolve_jtype_path

        uses_with = dict(uses_with or {})
        runtime_args = {"name": name, "workspace": workspace}
        if isinstance(uses, type) and issubclass(uses, BaseExecutor):
            return uses(runtime_args=runtime_args, workspace=workspace, **uses_with)
        if isinstance(uses, dict):
            return JAML.construct(uses, expected_cls=BaseExecutor, extra_kwargs={
                "runtime_args": runtime_args, "workspace": workspace, **uses_with})
        if isinstance(uses, str):
            if uses.startswith("hub://"):
                return _load_hub_executor(uses, runtime_args, uses_with)
            if not os.path.exists(uses) and "." in uses and "\n" not in uses:
                mod_name, _, cls_name = resolve_jtype_path(uses).rpartition(".")
                try:
                    klass = getattr(importlib.import_module(mod_name), cls_name)
                except (ImportError, AttributeError):
                    klass = None  # on to YAML, for a clear error
                if klass is not None:
                    # outside the try: an error in the constructor is the
                    # executor's own and goes up as it was raised
                    return klass(runtime_args=runtime_args, workspace=workspace, **uses_with)
            if os.path.isfile(uses) and uses.endswith((".yml", ".yaml")):
                _import_py_modules(uses)
            return BaseExecutor.load_config(uses, runtime_args=runtime_args, **uses_with)
        if uses is not None:
            raise TypeError(f"uses must be an executor class, a dotted path, a jtype "
                            f"mapping or YAML, got {uses!r}")
        return BaseExecutor(runtime_args=runtime_args)

    @property
    def executor(self) -> BaseExecutor:
        return self._executor

    def _make_batch_fn(self, endpoint: str):
        async def _fn(docs, parameters):
            return await self._executor.__acall__(endpoint, docs, parameters)

        return _fn

    @staticmethod
    def reduce_docs(requests: Sequence[DataRequest]) -> DocumentArray:
        """Merge the docs of a request matrix, deduped by id."""
        seen = set()
        merged = DocumentArray()
        for req in requests:
            for doc in req.docs:
                if doc.id not in seen:
                    seen.add(doc.id)
                    merged.append(doc)
        return merged

    @staticmethod
    def merge_routes(requests: Sequence[DataRequest]) -> None:
        """Merge the routes of a request matrix into the first request,
        deduped by executor."""
        if len(requests) <= 1:
            return
        seen = {r.executor for r in requests[0].routes}
        for request in requests[1:]:
            for route in request.routes:
                if route.executor not in seen:
                    requests[0].routes.append(route)
                    seen.add(route.executor)

    async def process_data(self, requests: Sequence[DataRequest]) -> DataRequest:
        """Execute one (or a matrix of) requests; returns the response.
        An endpoint's failure travels in the response's status."""
        req = requests[0]
        MDC.put("request_id", req.request_id)
        start = datetime.now(timezone.utc).isoformat()
        t0 = time.perf_counter()
        self._m_req_bytes.record(sum(r.nbytes for r in requests))
        job_id = (req.parameters or {}).get("job_id")
        await self._record_job(job_id, "started")
        try:
            target = req.target_executor
            if target and not _target_matches(target, self.name):
                return req  # not addressed to this executor: pass through
            if len(requests) > 1:
                docs = self.reduce_docs(requests)
                self.merge_routes(requests)
            else:
                docs = req.docs
            endpoint = req.exec_endpoint
            if (endpoint not in self._executor.requests
                    and "/default" not in self._executor.requests):
                # an executor that does not serve the endpoint passes the
                # docs through unchanged
                self.logger.debug(f"skip executor: endpoint mismatch {endpoint!r} "
                                  f"(serves {sorted(self._executor.requests)})")
                req.docs = docs
                return req
            if self._executor.is_generator_endpoint(endpoint):
                raise ValueError(f"endpoint {endpoint!r} is a generator endpoint — "
                                 "call it via stream_doc / POST /post_stream")
            # a dict under this executor's name overrides the top-level
            # parameters for this executor only
            call_params = req.parameters
            specific = call_params.get(self.name)
            if isinstance(specific, dict):
                call_params = {**call_params, **specific}

            if endpoint in self._batch_queues:
                param_key = json.dumps(call_params, sort_keys=True, default=str)
                instances = self._batch_queues[endpoint]
                queue = instances.get(param_key)
                if queue is None:
                    queue = instances[param_key] = BatchQueue(
                        self._make_batch_fn(endpoint), **self._batch_queue_config[endpoint])
                result = await queue.push(_clone_request(req, docs, call_params))
            else:
                result = await self._executor.__acall__(endpoint, docs, call_params)

            if isinstance(result, DocumentArray):
                req.docs = result
            elif isinstance(result, list) and all(hasattr(d, "id") for d in result):
                req.docs = DocumentArray(result)
            elif isinstance(result, dict):
                # a dict result rides in the parameters, under __results__
                # by executor
                params = req.parameters
                results_map = params.get("__results__", {})
                results_map[self.name] = result
                params["__results__"] = results_map
                req.parameters = params
                req.docs = docs
            else:
                req.docs = docs
            req.add_route(self.name, start, datetime.now(timezone.utc).isoformat())
            self._m_latency.record(time.perf_counter() - t0)
            self._m_docs.record(len(req.docs))
            await self._record_job(job_id, "successful")
            return req
        except Exception as ex:  # noqa: BLE001 — the error travels in the envelope
            self.logger.error(f"endpoint {req.exec_endpoint} failed: {ex!r}")
            req.add_exception(ex, executor=type(self._executor).__name__)
            self._m_failed.record(1)
            await self._record_job(job_id, "failed", error=repr(ex))
            return req
        finally:
            MDC.remove("request_id")

    def record_response_bytes(self, nbytes: int) -> None:
        """The size of a response as the server sent it."""
        self._m_resp_bytes.record(nbytes)

    async def process_single_doc_stream(self, req: DataRequest):
        """One document in, N out, each yielded as the endpoint produces
        it; a non-generator endpoint runs whole, then its docs are
        yielded."""
        endpoint = req.exec_endpoint
        if self._executor.is_generator_endpoint(endpoint):
            async for item in self._executor.__acall_stream__(endpoint, req.docs,
                                                              req.parameters):
                if isinstance(item, DocumentArray):
                    for d in item:
                        yield d
                else:
                    yield item
            return
        resp = await self.process_data([req])
        for d in resp.docs:
            yield d

    async def _record_job(self, job_id: Optional[str], state: str,
                          error: Optional[str] = None) -> None:
        """The job's started/failed/successful record in the KV."""
        if not job_id or self._job_kv is None:
            return
        try:
            record = {"state": state, "executor": self.name,
                      "timestamp": datetime.now(timezone.utc).isoformat()}
            if error:
                record["error"] = error
            await self._job_kv.internal_kv_put(
                f"job/{job_id}/worker/{self.name}", json.dumps(record).encode(),
                namespace="worker_jobs")
        except Exception as ex:  # noqa: BLE001 — bookkeeping must not fail serving
            self.logger.warning(f"job record write failed: {ex!r}")

    def endpoints(self) -> Dict[str, Any]:
        """Endpoint discovery payload."""
        return {"endpoints": sorted(self._executor.requests),
                "write_endpoints": list(self._executor.write_endpoints), "schemas": {}}

    def info(self) -> Dict[str, Any]:
        """The version table, and the kernels' launches in this process:
        the requests' (``kernel_launches``) and the warm-up's
        (``warmup``: seconds, launches, parts)."""
        from marie_tpu_torch.helper import get_full_version
        from marie_tpu_torch.ops.kernels._build import launch_counts
        from marie_tpu_torch.utils.program_zoo import warmup_report

        return {**get_full_version(), "kernel_launches": launch_counts(),
                "warmup": warmup_report()}

    def snapshot(self, snapshot_file: str) -> None:
        self._executor.snapshot(snapshot_file)

    def restore(self, snapshot_file: str) -> None:
        self._executor.restore(snapshot_file)

    async def close(self) -> None:
        if self._reload_task is not None:
            self._reload_task.cancel()
        for instances in self._batch_queues.values():
            for q in instances.values():
                await q.close()
        self._executor.close()


def _target_matches(pattern: str, name: str) -> bool:
    """``target_executor`` is a regex over executor names; a malformed
    pattern is compared as it stands."""
    try:
        return re.match(pattern, name) is not None
    except re.error:
        return pattern == name


def _clone_request(req: DataRequest, docs: DocumentArray,
                   parameters: Dict[str, Any]) -> DataRequest:
    clone = DataRequest()
    clone.request_id = req.request_id
    clone.exec_endpoint = req.exec_endpoint
    clone.parameters = parameters
    clone.docs = docs
    return clone


def _load_hub_executor(uses: str, runtime_args: Dict[str, Any],
                       uses_with: Dict[str, Any]) -> BaseExecutor:
    """The executor of a ``hub://`` reference: the bundle resolved and
    installed, put on ``sys.path``, its ``config.yml``'s ``py_modules``
    imported and the config loaded."""
    import sys

    from marie_tpu_torch.hub import ExecutorHub

    pkg_dir = ExecutorHub(registry_url=os.environ.get("MARIE_HUB_REGISTRY")).resolve(uses)
    if pkg_dir not in sys.path:
        sys.path.insert(0, os.path.dirname(pkg_dir))
        sys.path.insert(0, pkg_dir)
    config = os.path.join(pkg_dir, "config.yml")
    if not os.path.exists(config):
        raise FileNotFoundError(f"{uses}: bundle has no config.yml ({pkg_dir})")
    _import_py_modules(config)
    return BaseExecutor.load_config(config, runtime_args=runtime_args, **uses_with)


def _import_py_modules(config_path: str) -> None:
    """Import the ``py_modules`` a config file lists (paths relative to
    it), so that their executor classes register for ``jtype``."""
    import importlib.util
    import sys

    from marie_tpu_torch.jaml import JAML

    with open(config_path) as fp:
        cfg = JAML.load(fp) or {}
    base = os.path.dirname(os.path.abspath(config_path))
    for mod_rel in cfg.get("py_modules", []) or []:
        mod_name = os.path.splitext(os.path.basename(mod_rel))[0]
        spec = importlib.util.spec_from_file_location(f"marie_pymod_{mod_name}",
                                                      os.path.join(base, mod_rel))
        module = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = module
        spec.loader.exec_module(module)
