"""BaseExecutor (port of ``marie_tpu/serve/executors/__init__.py``): the
serving unit whose ``@requests`` endpoints a worker dispatches to.

It has the JAX executor's endpoint collection and ``requests`` remapping,
sync, async and generator dispatch, workspace, snapshot/restore hooks
and metrics, but no YAML base class (PyYAML is not on the card's
machine; JAML is ROADMAP item 3.4).  ``serve()`` builds a ``Deployment``
in the JAX package, which waits for the gRPC slice; a worker is served
over HTTP with :class:`marie_tpu_torch.orchestrate.pods.Pod`.  The model
work inside an executor runs on the card it is given (``device``).
"""

import asyncio
import inspect
import os
from types import SimpleNamespace
from typing import Any, Callable, Dict, Optional

from marie_tpu_torch.excepts import not_ported
from marie_tpu_torch.logging_core import MarieLogger

__all__ = ["BaseExecutor"]


def _call_kwargs(fn: Callable, docs, parameters, **kwargs) -> Dict[str, Any]:
    """The keywords of ``fn``'s signature among docs, parameters and
    ``kwargs``."""
    sig = inspect.signature(fn)
    out: Dict[str, Any] = {}
    if "docs" in sig.parameters:
        out["docs"] = docs
    if "parameters" in sig.parameters:
        out["parameters"] = parameters
    for k, v in kwargs.items():
        if k in sig.parameters:
            out[k] = v
    return out


class BaseExecutor:
    def __init__(
        self,
        metas: Optional[Dict[str, Any]] = None,
        requests: Optional[Dict[str, str]] = None,
        runtime_args: Optional[Dict[str, Any]] = None,
        workspace: Optional[str] = None,
        **kwargs,
    ):
        self.metas = SimpleNamespace(**(metas or {}))
        self.runtime_args = SimpleNamespace(**(runtime_args or {}))
        self._workspace = workspace
        self.logger = MarieLogger(type(self).__name__)

        # the @requests-decorated endpoints of the class
        self.requests: Dict[str, Callable] = {}
        for name in dir(type(self)):
            fn = getattr(type(self), name, None)
            for ep in getattr(fn, "__marie_endpoints__", []):
                self.requests[ep] = getattr(self, name)
        # remapping from configuration: {endpoint: method_name}
        for ep, method_name in (requests or {}).items():
            self.requests[ep] = getattr(self, method_name)

        self.dynamic_batching: Dict[str, Dict[str, Any]] = {}
        for ep, fn in self.requests.items():
            cfg = getattr(fn, "__marie_dynamic_batching__", None)
            if cfg:
                self.dynamic_batching[ep] = dict(cfg)

    @property
    def write_endpoints(self) -> list:
        """Endpoints marked ``@write``."""
        return sorted(ep for ep, fn in self.requests.items()
                      if getattr(getattr(fn, "__func__", fn), "__is_write__", False))

    @property
    def workspace(self) -> Optional[str]:
        ws = self._workspace or getattr(self.runtime_args, "workspace", None)
        if ws:
            os.makedirs(ws, exist_ok=True)
        return ws

    @property
    def deployment_name(self) -> str:
        return getattr(self.runtime_args, "name", type(self).__name__)

    def _record_metric(self, name: str, value: float, documentation: str = "") -> None:
        """A ``@monitor`` sample, into the process-wide registry that
        ``/metrics`` renders (the JAX executor's prometheus_client summary;
        that package is not on the card's machine)."""
        try:
            from marie_tpu_torch.metrics import MetricUnit, get_registry

            get_registry().metric(f"{self.deployment_name}_{name}".replace("-", "_"),
                                  MetricUnit.SECONDS).record(value)
        except Exception:  # noqa: BLE001 — metrics must never break serving
            pass

    def endpoint_for(self, exec_endpoint: str) -> Optional[Callable]:
        if exec_endpoint in self.requests:
            return self.requests[exec_endpoint]
        return self.requests.get("/default")

    def _endpoint(self, exec_endpoint: str) -> Callable:
        fn = self.endpoint_for(exec_endpoint)
        if fn is None:
            raise ValueError(f"{type(self).__name__} has no endpoint {exec_endpoint!r} "
                             f"(knows {sorted(self.requests)})")
        return fn

    async def __acall__(self, exec_endpoint: str, docs, parameters, **kwargs):
        """Dispatch one request to the bound endpoint (sync or async); a
        sync endpoint runs on the event loop's default thread pool."""
        fn = self._endpoint(exec_endpoint)
        call_kwargs = _call_kwargs(fn, docs, parameters, **kwargs)
        if inspect.iscoroutinefunction(fn):
            return await fn(**call_kwargs)
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(None, lambda: fn(**call_kwargs))

    def is_generator_endpoint(self, exec_endpoint: str) -> bool:
        """True when the bound endpoint is a (async) generator function:
        its documents stream out one at a time."""
        fn = self.endpoint_for(exec_endpoint)
        target = getattr(fn, "__func__", fn)
        return bool(getattr(target, "__is_generator__", False)) or (
            inspect.isasyncgenfunction(target) or inspect.isgeneratorfunction(target))

    async def __acall_stream__(self, exec_endpoint: str, docs, parameters):
        """Dispatch to a generator endpoint, yielding items as the endpoint
        produces them; a sync generator advances on the default pool."""
        fn = self._endpoint(exec_endpoint)
        call_kwargs = _call_kwargs(fn, docs, parameters)
        target = getattr(fn, "__func__", fn)
        if inspect.isasyncgenfunction(target):
            async for item in fn(**call_kwargs):
                yield item
            return
        if inspect.isgeneratorfunction(target):
            gen = fn(**call_kwargs)
            loop = asyncio.get_running_loop()
            sentinel = object()
            while True:
                item = await loop.run_in_executor(None, lambda: next(gen, sentinel))
                if item is sentinel:
                    return
                yield item
        raise ValueError(f"endpoint {exec_endpoint!r} is not a generator endpoint")

    def snapshot(self, snapshot_file: str) -> None:
        raise NotImplementedError(f"{type(self).__name__} does not implement snapshot")

    def restore(self, snapshot_file: str) -> None:
        raise NotImplementedError(f"{type(self).__name__} does not implement restore")

    def close(self) -> None:
        pass

    @classmethod
    def serve(cls, uses_with: Optional[Dict[str, Any]] = None, port: Optional[int] = None,
              protocol: str = "grpc", **kwargs):
        """Serve this executor standalone through a ``Deployment``."""
        raise not_ported("BaseExecutor.serve (a Deployment)")
