"""Prometheus monitoring (copy of ``marie_tpu/serve/monitoring.py``):
``MonitoringMixin``, a per-runtime ``prometheus_client`` registry and its
metrics server on ``port_monitoring``.  Without ``prometheus_client`` (the
card's machine has none) it warns and keeps ``metrics_registry`` None, and
its ``summary`` / ``counter`` give None.  The runtimes serve their own
``/metrics`` on the standard library
(``AsyncNewLoopRuntime._start_monitoring``).
"""

from typing import Optional

from marie_tpu_torch.logging_core import MarieLogger


class MonitoringMixin:
    def _setup_monitoring(
        self, monitoring: bool = False, port_monitoring: Optional[int] = None
    ) -> None:
        self.metrics_registry = None
        if not monitoring:
            return
        try:
            from prometheus_client import CollectorRegistry, start_http_server

            from marie_tpu_torch.helper import random_port

            self.metrics_registry = CollectorRegistry()
            port = port_monitoring or random_port()
            start_http_server(port, registry=self.metrics_registry)
            self.port_monitoring = port
            MarieLogger("monitoring").info(
                f"prometheus metrics on :{port}/metrics"
            )
        except Exception as ex:  # noqa: BLE001
            MarieLogger("monitoring").warning(f"monitoring unavailable: {ex!r}")

    def summary(self, name: str, documentation: str):
        if self.metrics_registry is None:
            return None
        from prometheus_client import Summary

        return Summary(name, documentation, registry=self.metrics_registry)

    def counter(self, name: str, documentation: str):
        if self.metrics_registry is None:
            return None
        from prometheus_client import Counter

        return Counter(name, documentation, registry=self.metrics_registry)
