"""The durable SQL Toast handler on sqlite3 (port of
``marie_tpu/messaging/sqlite_handler.py``): one row an event, read back
by job."""

import json
import os
import sqlite3
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional


class SqliteToastHandler:
    def __init__(self, db_path: Optional[str] = None):
        # the default lies under this process's temp directory (see
        # NativeToastHandler)
        db_path = db_path or os.path.join(tempfile.gettempdir(), "marie", "events.db")
        os.makedirs(os.path.dirname(db_path) or ".", exist_ok=True)
        self.db_path = db_path
        self._local = threading.local()
        conn = self._conn()
        conn.execute("CREATE TABLE IF NOT EXISTS events ("
                     "id INTEGER PRIMARY KEY AUTOINCREMENT, ts REAL, event TEXT, "
                     "job_id TEXT, payload TEXT)")
        conn.commit()

    def _conn(self) -> sqlite3.Connection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = sqlite3.connect(self.db_path, timeout=30)
            conn.execute("PRAGMA journal_mode=WAL")
            self._local.conn = conn
        return conn

    def notify(self, event: str, notification: Dict[str, Any], **kwargs) -> None:
        conn = self._conn()
        conn.execute("INSERT INTO events (ts, event, job_id, payload) VALUES (?,?,?,?)",
                     (time.time(), event, notification.get("job_id", ""),
                      json.dumps(notification)))
        conn.commit()

    def events_for(self, job_id: str) -> List[Dict[str, Any]]:
        rows = self._conn().execute(
            "SELECT event, payload FROM events WHERE job_id=? ORDER BY id", (job_id,)).fetchall()
        return [{"event": e, **json.loads(p)} for e, p in rows]
