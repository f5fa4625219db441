"""OpenTelemetry tracing and metrics (copy of
``marie_tpu/serve/instrumentation/__init__.py``).

Providers are made only when OpenTelemetry is asked for and installed;
otherwise every API is a no-op, so serving code instruments
unconditionally.  Without the SDK, a traces exporter host gets the
collector's own OTLP/HTTP JSON exporter (:mod:`.tracing`).
"""

import time
from typing import Any, Dict, Optional

from marie_tpu_torch.logging_core import MarieLogger


class InstrumentationMixin:
    """Adds tracer/meter to a runtime (no-op unless configured)."""

    def _setup_instrumentation(
        self,
        name: str = "marie",
        tracing: bool = False,
        traces_exporter_host: Optional[str] = None,
        traces_exporter_port: Optional[int] = None,
        metrics: bool = False,
        metrics_exporter_host: Optional[str] = None,
        metrics_exporter_port: Optional[int] = None,
    ) -> None:
        self.tracer = None
        self.meter = None
        logger = MarieLogger("instrumentation")
        if tracing:
            try:
                from opentelemetry import trace
                from opentelemetry.sdk.resources import Resource
                from opentelemetry.sdk.trace import TracerProvider

                provider = TracerProvider(
                    resource=Resource.create({"service.name": name})
                )
                if traces_exporter_host:
                    from opentelemetry.exporter.otlp.proto.grpc.trace_exporter import (
                        OTLPSpanExporter,
                    )
                    from opentelemetry.sdk.trace.export import BatchSpanProcessor

                    provider.add_span_processor(
                        BatchSpanProcessor(
                            OTLPSpanExporter(
                                endpoint=f"{traces_exporter_host}:{traces_exporter_port}",
                                insecure=True,
                            )
                        )
                    )
                trace.set_tracer_provider(provider)
                self.tracer = trace.get_tracer(name)
            except Exception as ex:  # noqa: BLE001 — missing exporter wheels
                logger.warning(f"otel SDK unavailable ({ex!r})")
                if traces_exporter_host:
                    # no-SDK fallback: the homegrown collector speaks
                    # OTLP/HTTP JSON directly (tracing.export_otlp_http)
                    from marie_tpu_torch.serve.instrumentation import tracing as _tr

                    host = traces_exporter_host
                    if "://" not in host:
                        host = f"http://{host}"
                    endpoint = f"{host}:{traces_exporter_port or 4318}"
                    self._otlp_stop = _tr.start_otlp_exporter(endpoint, name)
                    logger.info(f"OTLP/HTTP span exporter -> {endpoint}")
        if metrics:
            try:
                from opentelemetry import metrics as otel_metrics
                from opentelemetry.sdk.metrics import MeterProvider

                otel_metrics.set_meter_provider(MeterProvider())
                self.meter = otel_metrics.get_meter(name)
            except Exception as ex:  # noqa: BLE001
                logger.warning(f"otel metrics unavailable: {ex!r}")


class MetricsTimer:
    """Context manager recording elapsed seconds into a prometheus summary
    and/or an OpenTelemetry histogram."""

    def __init__(self, summary=None, histogram=None, labels: Optional[Dict[str, Any]] = None):
        self._summary = summary
        self._histogram = histogram
        self._labels = labels or {}

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        elapsed = time.perf_counter() - self._start
        if self._summary is not None:
            try:
                self._summary.observe(elapsed)
            except Exception:  # noqa: BLE001
                pass
        if self._histogram is not None:
            try:
                self._histogram.record(elapsed, self._labels)
            except Exception:  # noqa: BLE001
                pass
        return False
