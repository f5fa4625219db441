"""Mapped Diagnostic Context — per-task request-id threading (copy of
``marie_tpu/logging_core/mdc.py``).

Built on :mod:`contextvars`, so it propagates across asyncio tasks, not
just threads.
"""

import contextvars
from typing import Any, Dict, Optional

_mdc_var: contextvars.ContextVar[Optional[Dict[str, Any]]] = contextvars.ContextVar(
    "marie_mdc", default=None
)


class MDC:
    @staticmethod
    def put(key: str, value: Any) -> None:
        ctx = dict(_mdc_var.get() or {})
        ctx[key] = value
        _mdc_var.set(ctx)

    @staticmethod
    def get(key: str, default: Any = None) -> Any:
        ctx = _mdc_var.get() or {}
        return ctx.get(key, default)

    @staticmethod
    def get_all() -> Dict[str, Any]:
        return dict(_mdc_var.get() or {})

    @staticmethod
    def remove(key: str) -> None:
        ctx = dict(_mdc_var.get() or {})
        ctx.pop(key, None)
        _mdc_var.set(ctx)

    @staticmethod
    def clear() -> None:
        _mdc_var.set(None)
