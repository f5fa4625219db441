"""SQLite-backed KV (copy of ``marie_tpu/storage/kv/sqlite_kv.py``): the
``StorageArea`` interface over sqlite3 in WAL mode, safe across processes
on one host; the serving workers keep their job records in it."""

import sqlite3
import threading

from marie_tpu_torch.storage.kv.storage_client import StorageArea

_DEFAULT_NS = b"__default__"


class SqliteKV(StorageArea):
    def __init__(self, db_path: str = ":memory:", table: str = "kv_store"):
        self.db_path = db_path
        self.table = table
        self._local = threading.local()
        conn = self._conn()
        conn.execute(
            f"CREATE TABLE IF NOT EXISTS {table} ("
            "namespace BLOB NOT NULL, key BLOB NOT NULL, value BLOB, "
            "PRIMARY KEY (namespace, key))"
        )
        conn.commit()

    def _conn(self) -> sqlite3.Connection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = sqlite3.connect(self.db_path, timeout=30)
            conn.execute("PRAGMA journal_mode=WAL")
            self._local.conn = conn
        return conn

    async def internal_kv_get(self, key, namespace=None):
        row = self._conn().execute(
            f"SELECT value FROM {self.table} WHERE namespace=? AND key=?",
            (namespace or _DEFAULT_NS, key),
        ).fetchone()
        return row[0] if row else None

    async def internal_kv_put(self, key, value, overwrite=True, namespace=None):
        conn = self._conn()
        ns = namespace or _DEFAULT_NS
        if overwrite:
            conn.execute(
                f"INSERT OR REPLACE INTO {self.table} VALUES (?,?,?)",
                (ns, key, value),
            )
            conn.commit()
            return 1
        try:
            conn.execute(
                f"INSERT INTO {self.table} VALUES (?,?,?)", (ns, key, value)
            )
            conn.commit()
            return 1
        except sqlite3.IntegrityError:
            return 0

    async def internal_kv_del(self, key, namespace=None):
        conn = self._conn()
        cur = conn.execute(
            f"DELETE FROM {self.table} WHERE namespace=? AND key=?",
            (namespace or _DEFAULT_NS, key),
        )
        conn.commit()
        return cur.rowcount

    async def internal_kv_exists(self, key, namespace=None):
        return await self.internal_kv_get(key, namespace) is not None

    async def internal_kv_keys(self, prefix, namespace=None):
        rows = self._conn().execute(
            f"SELECT key FROM {self.table} WHERE namespace=?",
            (namespace or _DEFAULT_NS,),
        ).fetchall()
        return [r[0] for r in rows if r[0].startswith(prefix)]
