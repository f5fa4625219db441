"""Prometheus text exposition (format 0.0.4) of the process-wide
:class:`MetricRegistry` (copy of ``marie_tpu/metrics/prometheus.py``): no
client library, so every runtime can be scraped.  Summaries export their
lifetime ``_sum`` / ``_count`` and p50 / p95 gauges of the sample ring;
``count`` metrics export a ``_total`` counter.  :func:`render_launches`
adds the port's hand-written kernels' launch counts."""

import re
import threading
from typing import Optional

from marie_tpu_torch.metrics.metric import MetricRegistry, MetricUnit

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")

_global_registry: Optional[MetricRegistry] = None
_global_lock = threading.Lock()


def get_registry() -> MetricRegistry:
    """Process-wide registry the serving handlers record into."""
    global _global_registry
    with _global_lock:
        if _global_registry is None:
            _global_registry = MetricRegistry()
        return _global_registry


def _sanitize(name: str) -> str:
    return _NAME_RE.sub("_", name)


def _labels(dimensions: dict) -> str:
    if not dimensions:
        return ""
    inner = ",".join(
        f'{_sanitize(k)}="{str(v).replace(chr(92), "").replace(chr(34), "")}"'
        for k, v in sorted(dimensions.items())
    )
    return "{" + inner + "}"


def render_prometheus(registry: Optional[MetricRegistry] = None) -> str:
    """Render the registry in prometheus text exposition format 0.0.4."""
    registry = registry or get_registry()
    by_name: dict = {}
    with registry._lock:
        metrics = list(registry._metrics.values())
    for m in metrics:
        by_name.setdefault(m.name, []).append(m)

    lines = []
    for name in sorted(by_name):
        base = "marie_" + _sanitize(name)
        group = by_name[name]
        unit = group[0].unit
        if unit == MetricUnit.COUNT:
            lines.append(f"# TYPE {base}_total counter")
            for m in group:
                lines.append(f"{base}_total{_labels(m.dimensions)} {m.total:g}")
        else:
            lines.append(f"# TYPE {base} summary")
            for m in group:
                s = m.summary()
                lab = m.dimensions
                if s.get("count"):
                    for q_key, q in (("p50", "0.5"), ("p95", "0.95")):
                        ql = dict(lab)
                        ql["quantile"] = q
                        lines.append(f"{base}{_labels(ql)} {s[q_key]:g}")
                lines.append(f"{base}_sum{_labels(lab)} {m.total:g}")
                lines.append(f"{base}_count{_labels(lab)} {m.total_count}")
    return "\n".join(lines) + ("\n" if lines else "")


def render_launches(counts: dict, name: str = "marie_kernel_launches_total") -> str:
    """``{kernel: {path: launches}}`` as the counter ``name{kernel, path}``
    (``marie_warmup_launches_total`` for a warm-up's)."""
    if not counts:
        return ""
    lines = [f"# TYPE {name} counter"]
    for kernel in sorted(counts):
        for path in sorted(counts[kernel]):
            lines.append(f"{name}{_labels({'kernel': kernel, 'path': path})} "
                         f"{counts[kernel][path]}")
    return "\n".join(lines) + "\n"


def render_warmup(report: dict) -> str:
    """A warm-up report (``program_zoo.warmup_report``): its seconds as
    ``marie_warmup_seconds`` and its launches as
    ``marie_warmup_launches_total{kernel, path}``; nothing when no warm-up
    ran."""
    if not report.get("parts") and not report.get("launches"):
        return ""
    return (f"# TYPE marie_warmup_seconds gauge\nmarie_warmup_seconds {report['seconds']}\n"
            + render_launches(report.get("launches", {}), "marie_warmup_launches_total"))
