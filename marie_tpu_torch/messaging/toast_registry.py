"""Toast, the event-notification bus (port of
``marie_tpu/messaging/toast_registry.py``): handlers register for an
event-name prefix (``"*"`` for all); :meth:`Toast.notify` fans an event
out to every matching handler.  A handler that fails is logged, never
raised into the caller."""

import asyncio
from typing import Any, Dict, List

from marie_tpu_torch.logging_core import MarieLogger


class Toast:
    _handlers: Dict[str, List[Any]] = {}
    logger = MarieLogger("Toast")

    @classmethod
    def register(cls, handler, native: bool = False, event: str = "*") -> None:
        cls._handlers.setdefault(event, []).append(handler)

    @classmethod
    def unregister(cls, handler) -> None:
        for handlers in cls._handlers.values():
            while handler in handlers:
                handlers.remove(handler)

    @classmethod
    def unregister_all(cls) -> None:
        cls._handlers.clear()

    @classmethod
    def _matching(cls, event: str) -> List[Any]:
        out = []
        for pattern, handlers in cls._handlers.items():
            if pattern == "*" or event.startswith(pattern):
                out.extend(handlers)
        return out

    @classmethod
    async def notify(cls, event: str, notification: Dict[str, Any], **kwargs) -> None:
        for handler in cls._matching(event):
            try:
                result = handler.notify(event, notification, **kwargs)
                if asyncio.iscoroutine(result):
                    await result
            except Exception as ex:  # noqa: BLE001 — events must not break the flow
                cls.logger.error(f"toast handler {handler} failed: {ex!r}")

    @classmethod
    def notify_sync(cls, event: str, notification: Dict[str, Any], **kwargs) -> None:
        from marie_tpu_torch.helper import run_async

        run_async(cls.notify(event, notification, **kwargs))
