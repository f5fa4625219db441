"""Toast, the job events bus (port of ``marie_tpu/messaging/``): the
registry, the lifecycle publishers, the event payload, and the JSONL and
sqlite handlers.  The PostgreSQL and RabbitMQ handlers need drivers the
card's machine does not have and no ported path reaches; they stay in
ROADMAP item 12."""

from marie_tpu_torch.messaging.publisher import (
    mark_as_complete,
    mark_as_failed,
    mark_as_scheduled,
    mark_as_started,
)
from marie_tpu_torch.messaging.toast_registry import Toast

__all__ = ["Toast", "mark_as_scheduled", "mark_as_started", "mark_as_failed",
           "mark_as_complete"]
