"""``TimeContext`` (copy of the host timer of
``marie_tpu/logging_core/profile.py``; its device timer stays in the JAX
package).  It times host wall clock: work queued on the card is measured
only as far as the block waits for it."""

import time
from typing import Optional

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
