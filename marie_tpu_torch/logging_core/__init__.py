from marie_tpu_torch.logging_core.logger import MarieLogger, default_logger
from marie_tpu_torch.logging_core.mdc import MDC
from marie_tpu_torch.logging_core.profile import TimeContext

__all__ = ["MDC", "MarieLogger", "default_logger", "TimeContext"]
