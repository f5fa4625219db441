"""Standalone metric registry (copy of ``marie_tpu/metrics/metric.py``):
dimensioned metrics with units, a bounded ring of samples each, and
pluggable collectors."""

import threading
import time
from enum import Enum
from typing import Any, Callable, Dict, List, Optional, Tuple


class MetricUnit(str, Enum):
    COUNT = "count"
    SECONDS = "seconds"
    MILLISECONDS = "milliseconds"
    BYTES = "bytes"
    PERCENT = "percent"
    PAGES_PER_SECOND = "pages_per_second"
    NONE = "none"


class Metric:
    """A named, dimensioned measurement series (bounded ring of samples)."""

    def __init__(
        self,
        name: str,
        unit: MetricUnit = MetricUnit.NONE,
        dimensions: Optional[Dict[str, str]] = None,
        max_samples: int = 1024,
    ):
        self.name = name
        self.unit = unit
        self.dimensions = dict(dimensions or {})
        self.max_samples = max_samples
        self._samples: List[Tuple[float, float]] = []
        self._lock = threading.Lock()
        # monotonic accumulators (survive ring eviction; prometheus
        # counter/summary semantics need lifetime totals)
        self.total = 0.0
        self.total_count = 0

    def record(self, value: float, timestamp: Optional[float] = None) -> None:
        with self._lock:
            self._samples.append((timestamp or time.time(), float(value)))
            self.total += float(value)
            self.total_count += 1
            if len(self._samples) > self.max_samples:
                self._samples = self._samples[-self.max_samples :]

    @property
    def count(self) -> int:
        return len(self._samples)

    @property
    def last(self) -> Optional[float]:
        return self._samples[-1][1] if self._samples else None

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            values = [v for _, v in self._samples]
        if not values:
            return {"count": 0}
        values_sorted = sorted(values)
        n = len(values_sorted)
        return {
            "count": n,
            "min": values_sorted[0],
            "max": values_sorted[-1],
            "mean": sum(values_sorted) / n,
            "p50": values_sorted[n // 2],
            "p95": values_sorted[min(int(n * 0.95), n - 1)],
            "unit": self.unit.value,
        }


class MetricRegistry:
    def __init__(self):
        self._metrics: Dict[str, Metric] = {}
        self._collectors: List[Callable[[], Dict[str, float]]] = []
        self._lock = threading.Lock()

    def metric(
        self,
        name: str,
        unit: MetricUnit = MetricUnit.NONE,
        dimensions: Optional[Dict[str, str]] = None,
    ) -> Metric:
        key = name + "|" + ",".join(
            f"{k}={v}" for k, v in sorted((dimensions or {}).items())
        )
        with self._lock:
            if key not in self._metrics:
                self._metrics[key] = Metric(name, unit, dimensions)
            return self._metrics[key]

    def add_collector(self, fn: Callable[[], Dict[str, float]]) -> None:
        self._collectors.append(fn)

    def collect(self) -> None:
        """Run collectors, recording their values."""
        for fn in self._collectors:
            try:
                for name, value in fn().items():
                    self.metric(name).record(value)
            except Exception:  # noqa: BLE001 — collectors must not break
                pass

    def report(self) -> Dict[str, Any]:
        with self._lock:
            items = list(self._metrics.items())
        return {key: m.summary() for key, m in items}
