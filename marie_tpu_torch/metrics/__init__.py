from marie_tpu_torch.metrics.system_metrics import collect_system_metrics

__all__ = ["collect_system_metrics"]
