"""The job lifecycle publishers (port of
``marie_tpu/messaging/publisher.py``)."""

from typing import Any, Dict, Optional

from marie_tpu_torch.messaging.events import MarieEvent
from marie_tpu_torch.messaging.toast_registry import Toast


async def _publish(event_suffix: str, job_id: str, event_name: str, status: str,
                   payload: Optional[Dict[str, Any]] = None, api_key: str = "") -> None:
    ev = MarieEvent(api_key=api_key, job_id=job_id, event=f"{event_name}.{event_suffix}",
                    status=status, payload=payload)
    await Toast.notify(ev.event, ev.to_dict())


async def mark_as_scheduled(job_id: str, event_name: str = "job", **kwargs) -> None:
    await _publish("scheduled", job_id, event_name, "OK", **kwargs)


async def mark_as_started(job_id: str, event_name: str = "job", **kwargs) -> None:
    await _publish("started", job_id, event_name, "OK", **kwargs)


async def mark_as_failed(job_id: str, event_name: str = "job", **kwargs) -> None:
    await _publish("failed", job_id, event_name, "FAILED", **kwargs)


async def mark_as_complete(job_id: str, event_name: str = "job", **kwargs) -> None:
    await _publish("completed", job_id, event_name, "OK", **kwargs)
