from marie_tpu_torch.logging_core.logger import MarieLogger, default_logger
from marie_tpu_torch.logging_core.profile import TimeContext

__all__ = ["MarieLogger", "default_logger", "TimeContext"]
