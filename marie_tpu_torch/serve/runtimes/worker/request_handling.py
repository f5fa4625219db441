"""WorkerRequestHandler (port of
``marie_tpu/serve/runtimes/worker/request_handling.py``): loads the
executor and executes requests.

As the JAX handler: endpoint dispatch with executor-specific parameters,
dynamic-batching queues per (endpoint, parameters), the docs reduce of a
request matrix, generator endpoints through
:meth:`process_single_doc_stream`, endpoint discovery, the per-request
metrics and the job records in a sqlite KV (``job_kv_path`` or
``MARIE_JOB_KV``).  The executor comes from a class or a dotted class
path; a YAML ``uses`` waits for JAML (ROADMAP item 3.4), a hub reference
for the gRPC slice, and hot reload is not ported.
"""

import importlib
import json
import os
import re
import time
from datetime import datetime, timezone
from typing import Any, Dict, Optional, Sequence, Type, Union

from marie_tpu_torch.excepts import not_ported
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
        if hot_reload:
            raise not_ported("hot reload of the executor")
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

    @staticmethod
    def _load_executor(uses, uses_with, name, workspace) -> BaseExecutor:
        """The executor from a class or a dotted class path
        (``pkg.module.Class``), built with ``uses_with``."""
        uses_with = dict(uses_with or {})
        runtime_args = {"name": name, "workspace": workspace}
        if isinstance(uses, type) and issubclass(uses, BaseExecutor):
            return uses(runtime_args=runtime_args, workspace=workspace, **uses_with)
        if isinstance(uses, dict):
            raise NotImplementedError("an executor from a config dict needs JAML: "
                                      "ROADMAP §1 item 3.4")
        if isinstance(uses, str):
            if uses.startswith("hub://"):
                raise not_ported(f"the executor hub reference {uses!r}")
            if uses.endswith((".yml", ".yaml")) or "\n" in uses or os.path.exists(uses):
                raise NotImplementedError(f"an executor from YAML ({uses[:60]!r}) needs "
                                          "JAML: ROADMAP §1 item 3.4")
            mod_name, _, cls_name = uses.rpartition(".")
            if not mod_name:
                raise ValueError(f"uses {uses!r} is not a dotted class path")
            klass = getattr(importlib.import_module(mod_name), cls_name)
            return klass(runtime_args=runtime_args, workspace=workspace, **uses_with)
        if uses is not None:
            raise TypeError(f"uses must be an executor class or a dotted path, got {uses!r}")
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
        from marie_tpu_torch.helper import get_full_version

        return get_full_version()

    def snapshot(self, snapshot_file: str) -> None:
        self._executor.snapshot(snapshot_file)

    def restore(self, snapshot_file: str) -> None:
        self._executor.restore(snapshot_file)

    async def close(self) -> None:
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
