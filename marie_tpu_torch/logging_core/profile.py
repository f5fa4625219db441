"""Timers (port of ``marie_tpu/logging_core/profile.py``).

``TimeContext`` times a block by the host's wall clock.
``TimeContextTPU`` (the JAX name, kept so that callers port unchanged)
also waits on exit for the work queued on the card behind the tensors
that ``outputs_fn()`` returns, so asynchronous launches are measured: it
synchronises each CUDA device among them, and waits for nothing where
they are all on the CPU.  ``profiling`` logs the wall time of every call
of a function.
"""

import functools
import time
from typing import Any, Callable, Optional

from marie_tpu_torch.logging_core.logger import MarieLogger, default_logger


class TimeContext:
    """``with TimeContext('ocr', logger):`` logs the elapsed time on exit
    and keeps it in ``duration`` (seconds)."""

    def __init__(self, task_name: str, logger: Optional[MarieLogger] = None):
        self.task_name = task_name
        self._logger = logger or default_logger
        self.duration = 0.0

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.duration = time.perf_counter() - self.start
        self._logger.info(f"{self.task_name} took {self.duration:.3f}s")
        return False

    def now(self) -> float:
        return time.perf_counter() - self.start


def _cuda_devices(outputs: Any) -> set:
    """The CUDA devices of the tensors in ``outputs`` (nested lists,
    tuples and dict values)."""
    import torch

    found, stack = set(), [outputs]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.device.type == "cuda":
                found.add(x.device)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
    return found


class TimeContextTPU(TimeContext):
    """Time a block that launches asynchronous work on the card::

        with TimeContextTPU('detect', outputs_fn=lambda: [heatmap]):
            heatmap = detector(page)

    On a clean exit it synchronises every CUDA device that holds a
    tensor of ``outputs_fn()`` before it takes the time."""

    def __init__(self, task_name, logger=None, outputs_fn: Optional[Callable] = None):
        super().__init__(task_name, logger)
        self._outputs_fn = outputs_fn

    def __exit__(self, exc_type, exc_val, exc_tb):
        if exc_type is None and self._outputs_fn is not None:
            import torch

            for dev in _cuda_devices(self._outputs_fn()):
                torch.cuda.synchronize(dev)
        return super().__exit__(exc_type, exc_val, exc_tb)


def profiling(func: Callable) -> Callable:
    """Decorator logging the wall time of every call at DEBUG level."""

    @functools.wraps(func)
    def _wrapper(*args: Any, **kwargs: Any):
        t0 = time.perf_counter()
        try:
            return func(*args, **kwargs)
        finally:
            default_logger.debug(f"{func.__qualname__} took {time.perf_counter() - t0:.4f}s")

    return _wrapper
