"""The event payload (port of ``marie_tpu/messaging/events.py``): a
dataclass whose ``to_dict`` is the JAX pydantic model's ``model_dump``."""

import dataclasses
import time
from typing import Any, Dict, Optional


@dataclasses.dataclass
class MarieEvent:
    job_id: str
    event: str
    api_key: str = ""
    job_tag: str = ""
    status: str = ""
    timestamp: float = dataclasses.field(default_factory=time.time)
    payload: Optional[Dict[str, Any]] = None

    def to_dict(self) -> Dict[str, Any]:
        """The fields in the JAX model's order."""
        return {"api_key": self.api_key, "job_id": self.job_id, "event": self.event,
                "job_tag": self.job_tag, "status": self.status, "timestamp": self.timestamp,
                "payload": self.payload}
