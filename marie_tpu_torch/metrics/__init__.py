from marie_tpu_torch.metrics.metric import Metric, MetricRegistry, MetricUnit
from marie_tpu_torch.metrics.prometheus import get_registry, render_prometheus
from marie_tpu_torch.metrics.system_metrics import collect_system_metrics

__all__ = [
    "Metric",
    "MetricRegistry",
    "MetricUnit",
    "collect_system_metrics",
    "get_registry",
    "render_prometheus",
]
