"""Executor endpoint decorators (copy of
``marie_tpu/serve/executors/decorators.py``): ``@requests(on=...)`` binds
a method to endpoints, ``@write`` marks a state-changing endpoint,
``@dynamic_batching`` attaches batch-queue settings, ``@monitor`` records
a latency metric and ``safely_encoded`` makes results JSON-safe."""

import functools
import time
from typing import Callable, Optional, Sequence, Union

__all__ = ["requests", "write", "dynamic_batching", "monitor", "safely_encoded"]


def write(func: Optional[Callable] = None):
    """Mark an endpoint as a STATE-CHANGING write: in a stateful
    (RAFT-replicated) deployment only ``@write`` endpoints go through the
    consensus log; undecorated endpoints are reads served locally by any
    replica.

    Stack under ``@requests``::

        @requests(on="/index")
        @write
        def index(self, docs, **kwargs): ...
    """

    def _decorate(f: Callable) -> Callable:
        f.__is_write__ = True
        return f

    if func is not None and callable(func):
        return _decorate(func)
    return _decorate


def requests(
    func: Optional[Callable] = None,
    *,
    on: Optional[Union[str, Sequence[str]]] = None,
):
    """Bind an executor method to one or more endpoints.

    ``@requests`` (no args) binds the default endpoint ``/default`` which
    catches any unmatched endpoint.
    """

    def _decorate(f: Callable) -> Callable:
        endpoints = on if on is not None else "/default"
        if isinstance(endpoints, str):
            endpoints = [endpoints]
        existing = getattr(f, "__marie_endpoints__", [])
        f.__marie_endpoints__ = list(existing) + list(endpoints)
        # generator endpoints stream documents one at a time through
        # the worker's streaming path, which checks this flag
        import inspect as _inspect

        f.__is_generator__ = _inspect.isgeneratorfunction(
            f
        ) or _inspect.isasyncgenfunction(f)
        return f

    if func is not None and callable(func):
        return _decorate(func)
    return _decorate


def dynamic_batching(
    func: Optional[Callable] = None,
    *,
    preferred_batch_size: int = 4,
    timeout: float = 10_000,
    flush_all: bool = False,
):
    """Attach dynamic-batching config to an endpoint method (defaults:
    preferred_batch_size=4, timeout=10 s)."""

    def _decorate(f: Callable) -> Callable:
        f.__marie_dynamic_batching__ = {
            "preferred_batch_size": preferred_batch_size,
            "timeout": timeout,
            "flush_all": flush_all,
        }
        return f

    if func is not None and callable(func):
        return _decorate(func)
    return _decorate


def monitor(
    func: Optional[Callable] = None,
    *,
    name: Optional[str] = None,
    documentation: str = "",
):
    """Record wall-time of the wrapped method into the executor's metrics
    registry (prometheus summary when available)."""

    def _decorate(f: Callable) -> Callable:
        metric_name = name or f"{f.__name__}_seconds"

        @functools.wraps(f)
        def _wrapper(self, *args, **kwargs):
            t0 = time.perf_counter()
            try:
                return f(self, *args, **kwargs)
            finally:
                elapsed = time.perf_counter() - t0
                recorder = getattr(self, "_record_metric", None)
                if recorder is not None:
                    recorder(metric_name, elapsed, documentation)

        _wrapper.__marie_endpoints__ = getattr(f, "__marie_endpoints__", [])
        if hasattr(f, "__marie_dynamic_batching__"):
            _wrapper.__marie_dynamic_batching__ = f.__marie_dynamic_batching__
        return _wrapper

    if func is not None and callable(func):
        return _decorate(func)
    return _decorate


def safely_encoded(func: Callable) -> Callable:
    """Coerce the return value into JSON-safe python types (numpy
    scalars and arrays to numbers and lists, bytes to base64)."""

    @functools.wraps(func)
    def _wrapper(*args, **kwargs):
        return _jsonify(func(*args, **kwargs))

    return _wrapper


def _jsonify(obj):
    import numpy as np

    if isinstance(obj, dict):
        return {k: _jsonify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonify(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, bytes):
        import base64

        return base64.b64encode(obj).decode()
    return obj
