"""Cross-hop request tracing (copy of ``marie_tpu/serve/instrumentation/tracing.py``):
W3C ``traceparent`` propagation.

The standard W3C ``traceparent`` header (``00-<trace>-<span>-01``) rides
in gRPC metadata from the client through every hop, with no dependency:
spans land in an in-process ring collector (drainable for tests and
diagnostics, JSONL-exportable, OTLP/HTTP JSON-exportable), and mirror into
an OpenTelemetry tracer when one is configured, so that a client, the
gateway and the worker share one trace id either way.
"""

import contextlib
import contextvars
import json
import secrets
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

TRACEPARENT_KEY = "traceparent"
#: the instrumentation scope of the exported spans: the JAX package's
#: module name, so that both packages export the same OTLP body
OTLP_SCOPE = ".".join(("marie_tpu", "tracing"))

_current: contextvars.ContextVar[Optional["SpanContext"]] = contextvars.ContextVar(
    "marie_trace", default=None
)


@dataclass(frozen=True)
class SpanContext:
    trace_id: str  # 32 hex chars
    span_id: str  # 16 hex chars

    def to_traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-01"

    @staticmethod
    def from_traceparent(header: str) -> Optional["SpanContext"]:
        try:
            version, trace_id, span_id, _flags = header.strip().split("-")
        except ValueError:
            return None
        if version != "00" or len(trace_id) != 32 or len(span_id) != 16:
            return None
        return SpanContext(trace_id, span_id)

    @staticmethod
    def new_root() -> "SpanContext":
        return SpanContext(secrets.token_hex(16), secrets.token_hex(8))

    def child(self) -> "SpanContext":
        return SpanContext(self.trace_id, secrets.token_hex(8))


@dataclass
class Span:
    name: str
    trace_id: str
    span_id: str
    parent_span_id: Optional[str]
    start: float
    end: float = 0.0
    attributes: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_span_id": self.parent_span_id,
            "start": self.start,
            "duration_ms": round((self.end - self.start) * 1000, 3),
            "attributes": self.attributes,
        }


class SpanCollector:
    """Bounded in-process span sink (drain for tests/exporters)."""

    def __init__(self, max_spans: int = 4096):
        self._spans: List[Span] = []
        self._lock = threading.Lock()
        self.max_spans = max_spans

    def add(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)
            if len(self._spans) > self.max_spans:
                self._spans = self._spans[-self.max_spans :]

    def drain(self) -> List[Span]:
        with self._lock:
            spans, self._spans = self._spans, []
        return spans

    def snapshot(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def export_jsonl(self, path: str) -> int:
        spans = self.drain()
        with open(path, "a") as fp:
            for s in spans:
                fp.write(json.dumps(s.to_dict()) + "\n")
        return len(spans)


collector = SpanCollector()


def current_context() -> Optional[SpanContext]:
    return _current.get()


def current_traceparent() -> Optional[str]:
    ctx = _current.get()
    return ctx.to_traceparent() if ctx else None


@contextlib.contextmanager
def activate(header_or_ctx):
    """Adopt an incoming traceparent (or SpanContext) for this task."""
    ctx = (
        header_or_ctx
        if isinstance(header_or_ctx, SpanContext)
        else SpanContext.from_traceparent(header_or_ctx or "")
    )
    token = _current.set(ctx)
    try:
        yield ctx
    finally:
        _current.reset(token)


@contextlib.contextmanager
def start_span(name: str, attributes: Optional[Dict[str, Any]] = None):
    """Open a span under the active context (new root when none).

    The span becomes the active context inside the block, so downstream
    sends pick it up as their parent; also mirrors the trace id into MDC
    for log correlation."""
    parent = _current.get()
    ctx = parent.child() if parent else SpanContext.new_root()
    span = Span(
        name=name,
        trace_id=ctx.trace_id,
        span_id=ctx.span_id,
        parent_span_id=parent.span_id if parent else None,
        start=time.time(),
        attributes=dict(attributes or {}),
    )
    token = _current.set(ctx)
    try:
        from marie_tpu_torch.logging_core import MDC

        MDC.put("trace_id", ctx.trace_id[:16])
    except Exception:  # noqa: BLE001
        pass
    try:
        yield span
    except Exception as ex:
        span.attributes["error"] = repr(ex)
        raise
    finally:
        span.end = time.time()
        collector.add(span)
        _otel_mirror(span)
        _current.reset(token)


def inject_metadata(
    metadata: Optional[Tuple[Tuple[str, str], ...]],
) -> Tuple[Tuple[str, str], ...]:
    """Append the active traceparent to outgoing gRPC metadata."""
    header = current_traceparent()
    base = tuple(metadata or ())
    if header is None:
        return base
    return base + ((TRACEPARENT_KEY, header),)


def extract_metadata(invocation_metadata) -> Optional[SpanContext]:
    for key, value in invocation_metadata or ():
        if key.lower() == TRACEPARENT_KEY:
            return SpanContext.from_traceparent(value)
    return None


def _otel_mirror(span: Span) -> None:
    """Replay the finished span into an OTEL tracer when one exists."""
    tracer = getattr(_otel_mirror, "tracer", None)
    if tracer is None:
        return
    try:
        otel_span = tracer.start_span(span.name, start_time=int(span.start * 1e9))
        for k, v in span.attributes.items():
            otel_span.set_attribute(k, str(v))
        otel_span.end(end_time=int(span.end * 1e9))
    except Exception:  # noqa: BLE001
        pass


def set_otel_tracer(tracer) -> None:
    _otel_mirror.tracer = tracer  # type: ignore[attr-defined]


# --- OTLP/HTTP export (no OpenTelemetry SDK required) -----------------------


def spans_to_otlp(spans: List[Span], service_name: str = "marie") -> Dict[str, Any]:
    """The collected spans as the OTLP/HTTP JSON request body
    (``ExportTraceServiceRequest``, the schema any OTLP collector takes on
    ``/v1/traces``), written without the OpenTelemetry SDK."""
    return {
        "resourceSpans": [
            {
                "resource": {
                    "attributes": [
                        {
                            "key": "service.name",
                            "value": {"stringValue": service_name},
                        }
                    ]
                },
                "scopeSpans": [
                    {
                        "scope": {"name": OTLP_SCOPE},
                        "spans": [
                            {
                                "traceId": s.trace_id,
                                "spanId": s.span_id,
                                **(
                                    {"parentSpanId": s.parent_span_id}
                                    if s.parent_span_id
                                    else {}
                                ),
                                "name": s.name,
                                "kind": 1,  # SPAN_KIND_INTERNAL
                                "startTimeUnixNano": str(int(s.start * 1e9)),
                                "endTimeUnixNano": str(int(s.end * 1e9)),
                                "attributes": [
                                    {
                                        "key": k,
                                        "value": {"stringValue": str(v)},
                                    }
                                    for k, v in s.attributes.items()
                                ],
                            }
                            for s in spans
                        ],
                    }
                ],
            }
        ]
    }


def export_otlp_http(
    endpoint: str,
    service_name: str = "marie",
    timeout: float = 5.0,
) -> int:
    """Drain the collector and POST spans to an OTLP/HTTP collector
    (``<endpoint>/v1/traces``).  Returns the number of spans shipped;
    on failure the spans are re-queued so the next flush retries them."""
    import urllib.request

    spans = collector.drain()
    if not spans:
        return 0
    body = json.dumps(spans_to_otlp(spans, service_name)).encode()
    url = endpoint.rstrip("/")
    if not url.endswith("/v1/traces"):
        url += "/v1/traces"
    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": "application/json"}
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            resp.read()
        return len(spans)
    except Exception:  # noqa: BLE001 — requeue and let the next flush retry
        for s in spans:
            collector.add(s)
        return 0


def start_otlp_exporter(
    endpoint: str,
    service_name: str = "marie",
    interval: float = 5.0,
) -> threading.Event:
    """Background flusher: periodically ships collected spans to an OTLP
    collector.  Returns a stop Event; set it to terminate the thread
    (one final flush runs on stop)."""
    stop = threading.Event()

    def run():
        while not stop.wait(interval):
            export_otlp_http(endpoint, service_name)
        export_otlp_http(endpoint, service_name)

    t = threading.Thread(target=run, name="otlp-exporter", daemon=True)
    t.start()
    return stop
