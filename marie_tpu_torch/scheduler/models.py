"""The scheduler's data models (port of ``marie_tpu/scheduler/models.py``):
dataclasses in place of the JAX package's pydantic models (pydantic is not
on the card's machine).  Fields are coerced to their declared types as
pydantic coerces them, and ``model_dump`` gives pydantic's dict
(``mode="json"``: enums as their values)."""

import dataclasses
import time
import uuid
from typing import Any, Dict, Optional

from marie_tpu_torch.enums import WorkState


def _coerce(obj) -> None:
    """Each field of ``obj`` as its declared scalar type (None kept where
    the field is optional)."""
    for f in dataclasses.fields(obj):
        value = getattr(obj, f.name)
        kind = f.type if isinstance(f.type, str) else getattr(f.type, "__name__", "")
        if value is None:
            continue
        if kind == "float" or kind == "Optional[float]":
            setattr(obj, f.name, float(value))
        elif kind == "int":
            setattr(obj, f.name, int(value))
        elif kind == "bool":
            setattr(obj, f.name, bool(value))


def model_dump(obj, mode: str = "python") -> Dict[str, Any]:
    """pydantic's ``model_dump`` of a dataclass model: its fields in order;
    ``mode="json"`` gives enums as their values."""
    out = {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
    if mode == "json":
        out = {k: (v.value if hasattr(v, "value") and isinstance(v, str) else v)
               for k, v in out.items()}
    return {k: (dict(v) if isinstance(v, dict) else v) for k, v in out.items()}


@dataclasses.dataclass(kw_only=True)
class RetryPolicy:
    retry_limit: "int" = 2
    retry_delay: "float" = 1.0
    retry_backoff: "bool" = True

    def __post_init__(self):
        _coerce(self)


DEFAULT_RETRY_POLICY = RetryPolicy()


class ExistingWorkPolicy:
    """What to do when a job with the same name already exists."""

    KEEP_EXISTING = "keep_existing"
    REPLACE_EXISTING = "replace_existing"
    ALLOW_DUPLICATE = "allow_duplicate"
    REJECT_DUPLICATE = "reject_duplicate"


@dataclasses.dataclass(kw_only=True)
class WorkInfo:
    """One job of a queue (``name``), with its retry budget, schedule and
    retention; ``dead_letter`` names the queue a job's payload moves to
    when its retries run out or it expires, ``output`` holds the handler's
    result or the terminal error."""

    id: "str" = dataclasses.field(default_factory=lambda: uuid.uuid4().hex)
    name: "str"
    priority: "int" = 0
    state: WorkState = WorkState.CREATED
    retry_limit: "int" = 2
    retry_count: "int" = 0
    retry_delay: "float" = 1.0
    retry_backoff: "bool" = True
    start_after: "float" = 0.0  # unix ts; 0 = now
    expire_in_seconds: "float" = 0.0
    data: Dict[str, Any] = dataclasses.field(default_factory=dict)
    created_on: "float" = dataclasses.field(default_factory=time.time)
    started_on: "Optional[float]" = None
    completed_on: "Optional[float]" = None
    policy: "str" = ExistingWorkPolicy.ALLOW_DUPLICATE
    dead_letter: Optional[str] = None
    keep_until: "float" = 0.0
    output: Optional[Any] = None

    def __post_init__(self):
        _coerce(self)
        self.state = WorkState(self.state)

    def model_dump(self, mode: str = "python") -> Dict[str, Any]:
        return model_dump(self, mode)

    def to_row(self) -> Dict[str, Any]:
        d = self.model_dump()
        d["state"] = self.state.value
        return d
