"""The JSONL Toast handler (port of
``marie_tpu/messaging/native_handler.py``): one JSON line an event."""

import json
import os
import tempfile
import threading
from typing import Any, Dict, Optional


class NativeToastHandler:
    def __init__(self, path: Optional[str] = None):
        # the default lies under this process's temp directory, so checkouts
        # that run side by side with their own TMPDIR never share a log
        path = path or os.path.join(tempfile.gettempdir(), "marie", "events.jsonl")
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._lock = threading.Lock()

    def notify(self, event: str, notification: Dict[str, Any], **kwargs) -> None:
        with self._lock, open(self.path, "a") as fp:
            fp.write(json.dumps({"event": event, **notification}) + "\n")
