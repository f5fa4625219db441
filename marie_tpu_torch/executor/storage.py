"""Executor-side result persistence (port of ``marie_tpu/executor/storage.py``):
``StorageMixin`` and ``PostgreSQLStorage``.

Executors call ``setup_storage(storage_enabled, storage_conf,
silence_exceptions)`` in ``__init__`` and ``store(ref_id, ref_type,
store_mode, docs)`` after each unit of work.  The storage is a table of
doc_id (primary key), ref_id, ref_type, store_mode, tags, embedding,
blob, content, doc, a sha256 virtual shard, timestamps and a soft-delete
flag, over an injected DBAPI connection: stdlib sqlite3 (``{"provider":
"sqlite", "path": ...}`` or a ``conn_factory``) or psycopg2, imported
only for a postgres configuration, where it raises if the driver is
missing.  The ``doc`` store mode keeps the document's ``to_dict`` (the
JAX package keeps pydantic's JSON dump).
"""

import hashlib
import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from marie_tpu_torch.excepts import BadConfigSource
from marie_tpu_torch.logging_core import MarieLogger

META_TABLE = "metas"
_SCHEMA_VERSION = 2


def _json(value: Any) -> Optional[str]:
    if value is None:
        return None
    return json.dumps(value, default=str)


class PostgreSQLStorage:
    """Document storage indexer over an injected DBAPI connection.

    ``store_mode`` selects which part of a :class:`StorageDoc` lands in
    its dedicated column (the others stay NULL): ``content`` | ``blob``
    | ``embedding`` | ``doc`` (full JSON).
    """

    def __init__(
        self,
        conn_factory: Callable[[], Any],
        table: str = "default_table",
        virtual_shards: int = 128,
        paramstyle: str = "%s",
        dialect: str = "postgres",
    ):
        self.table = table
        self.virtual_shards = int(virtual_shards)
        self.paramstyle = paramstyle
        self.dialect = dialect
        self.logger = MarieLogger(self.__class__.__name__)
        # serving endpoints run on runtime threads, not the __init__
        # thread — serialize all DBAPI access behind one lock (sqlite
        # additionally needs check_same_thread=False, see
        # _storage_from_conf)
        self._lock = threading.RLock()
        self._conn = conn_factory()
        self._ensure_schema()

    # -- schema ---------------------------------------------------------
    def _p(self, sql: str) -> str:
        return sql.replace("%s", self.paramstyle)

    def _execute(self, sql: str, params: Sequence[Any] = ()):
        with self._lock:
            cur = self._conn.cursor()
            cur.execute(self._p(sql), tuple(params))
            return cur

    def _commit(self) -> None:
        with self._lock:
            self._conn.commit()

    def _ensure_schema(self) -> None:
        ddl = (
            "CREATE TABLE IF NOT EXISTS {t} ("
            " doc_id TEXT PRIMARY KEY,"
            " ref_id TEXT,"
            " ref_type TEXT,"
            " store_mode TEXT,"
            " tags TEXT,"
            " embedding TEXT,"
            " blob BLOB,"
            " content TEXT,"
            " doc TEXT,"
            " shard INTEGER,"
            " created_at REAL,"
            " updated_at REAL,"
            " is_deleted INTEGER DEFAULT 0)"
        )
        if self.dialect == "postgres":
            ddl = ddl.replace(" BLOB", " BYTEA").replace(
                "is_deleted INTEGER", "is_deleted BOOLEAN"
            )
        self._execute(ddl.format(t=self.table))
        self._execute(
            f"CREATE TABLE IF NOT EXISTS {META_TABLE} "
            "(table_name TEXT PRIMARY KEY, schema_version INTEGER)"
        )
        cur = self._execute(
            f"SELECT schema_version FROM {META_TABLE} WHERE table_name = %s",
            (self.table,),
        )
        if cur.fetchone() is None:
            self._execute(
                f"INSERT INTO {META_TABLE} (table_name, schema_version) "
                "VALUES (%s, %s)",
                (self.table, _SCHEMA_VERSION),
            )
        self._commit()

    # -- shard assignment -------------------------------------------------
    def _get_next_shard(self, doc_id: str) -> int:
        sha = hashlib.sha256()
        sha.update(bytes(doc_id, "utf-8"))
        return int(sha.hexdigest(), 16) % self.virtual_shards

    # -- mutation ---------------------------------------------------------
    def add(
        self,
        docs: Sequence[Any],
        store_mode: str = "content",
        ref_id: Optional[str] = None,
        ref_type: Optional[str] = None,
    ) -> int:
        """Upsert docs; returns the number written."""
        if not docs:
            return 0
        if store_mode not in ("content", "blob", "embedding", "doc"):
            raise ValueError(f"invalid store_mode: {store_mode!r}")
        now = time.time()
        n = 0
        for doc in docs:
            doc_id = str(getattr(doc, "id", None) or hashlib.sha256(
                repr(doc).encode()).hexdigest()[:32])
            tags = _json(getattr(doc, "tags", None))
            content = blob = embedding = doc_json = None
            if store_mode == "content":
                content = _json(getattr(doc, "content", None))
            elif store_mode == "blob":
                raw = getattr(doc, "blob", None)
                blob = bytes(raw) if raw is not None else None
            elif store_mode == "embedding":
                emb = getattr(doc, "embedding", None)
                embedding = _json(
                    np.asarray(emb, dtype=float).tolist()
                    if emb is not None else None
                )
            else:  # doc — full JSON snapshot
                doc_json = _json(_doc_to_dict(doc))
            upsert = (
                f"INSERT INTO {self.table} (doc_id, ref_id, ref_type,"
                " store_mode, tags, embedding, blob, content, doc, shard,"
                " created_at, updated_at, is_deleted)"
                " VALUES (%s,%s,%s,%s,%s,%s,%s,%s,%s,%s,%s,%s,0)"
                " ON CONFLICT (doc_id) DO UPDATE SET"
                " ref_id=excluded.ref_id, ref_type=excluded.ref_type,"
                " store_mode=excluded.store_mode, tags=excluded.tags,"
                " embedding=excluded.embedding, blob=excluded.blob,"
                " content=excluded.content, doc=excluded.doc,"
                " updated_at=excluded.updated_at, is_deleted=0"
            )
            self._execute(
                upsert,
                (doc_id, ref_id, ref_type, store_mode, tags, embedding,
                 blob, content, doc_json, self._get_next_shard(doc_id),
                 now, now),
            )
            n += 1
        self._commit()
        return n

    def delete(self, doc_id: str, soft: bool = True) -> None:
        if soft:
            self._execute(
                f"UPDATE {self.table} SET is_deleted = 1, updated_at = %s"
                " WHERE doc_id = %s",
                (time.time(), doc_id),
            )
        else:
            self._execute(
                f"DELETE FROM {self.table} WHERE doc_id = %s", (doc_id,)
            )
        self._commit()

    # -- reads ------------------------------------------------------------
    def get(self, doc_id: str) -> Optional[Dict[str, Any]]:
        cur = self._execute(
            f"SELECT doc_id, ref_id, ref_type, store_mode, tags, embedding,"
            f" blob, content, doc FROM {self.table}"
            " WHERE doc_id = %s AND is_deleted = 0",
            (doc_id,),
        )
        row = cur.fetchone()
        if row is None:
            return None
        keys = ("doc_id", "ref_id", "ref_type", "store_mode", "tags",
                "embedding", "blob", "content", "doc")
        out = dict(zip(keys, row))
        for k in ("tags", "embedding", "content", "doc"):
            if out[k] is not None:
                out[k] = json.loads(out[k])
        return out

    def list_by_ref(self, ref_id: str) -> List[Dict[str, Any]]:
        cur = self._execute(
            f"SELECT doc_id FROM {self.table}"
            " WHERE ref_id = %s AND is_deleted = 0 ORDER BY doc_id",
            (ref_id,),
        )
        return [self.get(r[0]) for r in cur.fetchall()]

    @property
    def size(self) -> int:
        cur = self._execute(
            f"SELECT COUNT(*) FROM {self.table} WHERE is_deleted = 0"
        )
        return int(cur.fetchone()[0])

    # -- snapshot (rolling-update reads) ------------------------------------
    def snapshot(self) -> int:
        """Copy live rows into ``<table>_snapshot`` (replacing any prior
        snapshot); returns the snapshot row count."""
        snap = f"{self.table}_snapshot"
        self._execute(f"DROP TABLE IF EXISTS {snap}")
        self._execute(
            f"CREATE TABLE {snap} AS SELECT * FROM {self.table}"
            " WHERE is_deleted = 0"
        )
        self._commit()
        return self.snapshot_size

    @property
    def snapshot_size(self) -> int:
        try:
            cur = self._execute(
                f"SELECT COUNT(*) FROM {self.table}_snapshot"
            )
            return int(cur.fetchone()[0])
        except Exception:  # noqa: BLE001 — no snapshot yet
            return 0

    def get_snapshot(self, shards_to_get: Sequence[int]):
        """Rows of the snapshot belonging to a virtual-shard subset."""
        shards = ",".join(str(int(s)) for s in shards_to_get)
        cur = self._execute(
            f"SELECT doc_id, doc, embedding FROM {self.table}_snapshot"
            f" WHERE shard IN ({shards})"
        )
        return cur.fetchall()

    # -- similarity search --------------------------------------------------
    def similarity_search_with_score(
        self, query_vector, k: int = 5
    ) -> List[Tuple[str, float]]:
        """Top-k (doc_id, L2 distance) over embedding-mode rows.

        postgres dialect: pgvector ``<->`` order pushed to the server;
        otherwise an exact host-side search over fetched embeddings.
        """
        q = np.asarray(query_vector, dtype=float)
        if self.dialect == "postgres":
            cur = self._execute(
                f"SELECT doc_id, embedding <-> %s AS score FROM {self.table}"
                " WHERE store_mode = 'embedding' AND is_deleted = 0"
                " ORDER BY score LIMIT %s",
                (q.tolist(), int(k)),
            )
            return [(r[0], float(r[1])) for r in cur.fetchall()]
        cur = self._execute(
            f"SELECT doc_id, embedding FROM {self.table}"
            " WHERE store_mode = 'embedding' AND is_deleted = 0"
        )
        scored = [
            (doc_id, float(np.linalg.norm(np.asarray(json.loads(emb)) - q)))
            for doc_id, emb in cur.fetchall()
            if emb is not None
        ]
        scored.sort(key=lambda t: t[1])
        return scored[:k]

    def similarity_search(self, query_vector, k: int = 5) -> List[str]:
        return [d for d, _ in self.similarity_search_with_score(query_vector, k)]

    def close(self) -> None:
        try:
            self._conn.close()
        except Exception:  # noqa: BLE001
            pass


def _doc_to_dict(doc: Any) -> Dict[str, Any]:
    if hasattr(doc, "to_dict"):
        try:
            return doc.to_dict()
        except Exception:  # noqa: BLE001 — fields JSON cannot hold
            pass
    out = {}
    for field in ("id", "content", "tags"):
        v = getattr(doc, field, None)
        if v is not None:
            out[field] = v
    emb = getattr(doc, "embedding", None)
    if emb is not None:
        out["embedding"] = np.asarray(emb, dtype=float).tolist()
    return out


class StorageMixin:
    """Executor mixin providing result persistence: executors call ``setup_storage``
    in ``__init__`` and ``store(...)`` after each unit of work."""

    storage_enabled: bool = False
    storage: Optional[PostgreSQLStorage] = None

    def setup_storage(
        self,
        storage_enabled: bool = False,
        storage_conf: Optional[Dict[str, Any]] = None,
        silence_exceptions: bool = False,
    ) -> None:
        self.storage_enabled = bool(storage_enabled)
        self.storage = None
        if not storage_enabled:
            return
        try:
            self.storage = _storage_from_conf(storage_conf or {})
        except Exception as e:  # noqa: BLE001 — config decides severity
            if silence_exceptions:
                getattr(self, "logger", MarieLogger("storage")).warning(
                    f"Storage enabled but config not setup correctly: {e!r}"
                )
                self.storage_enabled = False
            else:
                raise BadConfigSource(
                    "Storage enabled but config not setup correctly"
                ) from e

    def store(
        self,
        ref_id: str,
        ref_type: str,
        store_mode: str,
        docs: Sequence[Any],
    ) -> int:
        """Persist docs; never raises into the serving path (failures are
        logged: storing is fire-and-forget)."""
        if not self.storage_enabled or self.storage is None:
            return 0
        try:
            return self.storage.add(
                docs, store_mode=store_mode, ref_id=ref_id, ref_type=ref_type
            )
        except Exception as e:  # noqa: BLE001 — storage must not kill serving
            getattr(self, "logger", MarieLogger("storage")).error(
                f"store failed for ref_id={ref_id}: {e!r}"
            )
            return 0


def _storage_from_conf(conf: Dict[str, Any]) -> PostgreSQLStorage:
    """Build storage from a config dict.

    Accepted forms:
    - ``{"conn_factory": callable, ...}`` — injected DBAPI (tests, custom)
    - ``{"provider": "sqlite", "path": "/x.db", ...}`` — stdlib sqlite3
    - ``{"hostname":..., "port":..., "username":..., "password":...,
       "database":..., "default_table":...}`` — psycopg2 (the postgres shape;
       requires the driver at runtime)
    """
    table = conf.get("default_table", conf.get("table", "default_table"))
    shards = int(conf.get("virtual_shards", 128))
    if callable(conf.get("conn_factory")):
        return PostgreSQLStorage(
            conf["conn_factory"], table=table, virtual_shards=shards,
            paramstyle=conf.get("paramstyle", "?"),
            dialect=conf.get("dialect", "sqlite"),
        )
    if conf.get("provider") == "sqlite":
        import sqlite3

        path = conf.get("path", ":memory:")
        return PostgreSQLStorage(
            lambda: sqlite3.connect(path, check_same_thread=False),
            table=table,
            virtual_shards=shards, paramstyle="?", dialect="sqlite",
        )
    import psycopg2  # noqa: F401 — a postgres config needs the driver

    def _connect():
        return psycopg2.connect(
            host=conf["hostname"], port=int(conf.get("port", 5432)),
            user=conf["username"], password=conf["password"],
            dbname=conf["database"],
        )

    return PostgreSQLStorage(
        _connect, table=table, virtual_shards=shards,
        paramstyle="%s", dialect="postgres",
    )
