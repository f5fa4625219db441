"""The SQL job scheduler (port of ``marie_tpu/scheduler/sql.py``) with
pg-boss queue semantics on sqlite3 (WAL).

A job table with its state machine (created -> active ->
completed / failed / retry / cancelled / expired); an atomic claim (on
sqlite a SELECT and a conditional UPDATE in one transaction, on
PostgreSQL one ``UPDATE ... FOR UPDATE SKIP LOCKED ... RETURNING``: no two
pollers get the same job); retries with backoff; an adaptive poll interval
(POLL_MIN to POLL_MAX seconds); a monitor loop that fires cron schedules,
expires overdue jobs and archives old terminal ones; ``dead_letter``
routing, ``keep_until`` retention and a stored ``output``.  A
``connection_factory`` with ``dialect="postgresql"`` runs the same
statements on a PostgreSQL DB-API connection (placeholders rewritten to
``%s``).  Times are REAL epoch seconds.
"""

import asyncio
import json
import sqlite3
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from marie_tpu_torch.enums import WorkState
from marie_tpu_torch.logging_core import MarieLogger
from marie_tpu_torch.scheduler.job_scheduler import JobScheduler
from marie_tpu_torch.scheduler.models import ExistingWorkPolicy, WorkInfo

POLL_MIN = 1.25
POLL_MAX = 16.0
MONITOR_INTERVAL = 5.0

_SCHEMA = """
CREATE TABLE IF NOT EXISTS job (
  id TEXT PRIMARY KEY,
  name TEXT NOT NULL,
  priority INTEGER DEFAULT 0,
  state TEXT NOT NULL,
  retry_limit INTEGER DEFAULT 2,
  retry_count INTEGER DEFAULT 0,
  retry_delay REAL DEFAULT 1.0,
  retry_backoff INTEGER DEFAULT 1,
  start_after REAL DEFAULT 0,
  expire_in_seconds REAL DEFAULT 0,
  data TEXT,
  created_on REAL,
  started_on REAL,
  completed_on REAL,
  dead_letter TEXT,
  keep_until REAL DEFAULT 0,
  output TEXT
);
CREATE INDEX IF NOT EXISTS job_fetch_idx ON job (name, state, priority DESC, created_on);
CREATE TABLE IF NOT EXISTS job_history (
  id TEXT, state TEXT, ts REAL, detail TEXT
);
CREATE TABLE IF NOT EXISTS archive (
  id TEXT PRIMARY KEY, name TEXT, state TEXT, data TEXT, archived_on REAL
);
CREATE TABLE IF NOT EXISTS schedule (
  name TEXT PRIMARY KEY,
  cron TEXT NOT NULL,
  data TEXT,
  created_on REAL,
  updated_on REAL,
  last_fired_minute INTEGER DEFAULT -1
);
"""


def _cron_field_matches(field: str, value: int, lo: int, hi: int) -> bool:
    """One cron field against a value: ``*``, ``*/n``, lists, ranges."""
    for part in field.split(","):
        part = part.strip()
        step = 1
        if "/" in part:
            part, _, step_s = part.partition("/")
            step = int(step_s)
        if part in ("*", ""):
            start, end = lo, hi
        elif "-" in part:
            a, _, b = part.partition("-")
            start, end = int(a), int(b)
        else:
            start = end = int(part)
        if start <= value <= end and (value - start) % step == 0:
            return True
    return False


def cron_matches(expr: str, t: time.struct_time) -> bool:
    """5-field cron (minute hour day-of-month month day-of-week; dow
    0=Sunday like pg-boss/vixie cron).  Raises ValueError on malformed
    expressions."""
    fields = expr.split()
    if len(fields) != 5:
        raise ValueError(f"cron needs 5 fields: {expr!r}")
    minute, hour, dom, month, dow = fields
    wday = (t.tm_wday + 1) % 7  # struct_time: Monday=0 → cron Sunday=0
    return (
        _cron_field_matches(minute, t.tm_min, 0, 59)
        and _cron_field_matches(hour, t.tm_hour, 0, 23)
        and _cron_field_matches(dom, t.tm_mday, 1, 31)
        and _cron_field_matches(month, t.tm_mon, 1, 12)
        and _cron_field_matches(dow, wday, 0, 6)
    )


class SqlJobScheduler(JobScheduler):
    def __init__(
        self,
        db_path: Optional[str] = None,
        job_handler: Optional[Callable] = None,  # async fn(WorkInfo) -> bool
        queue_names: Optional[List[str]] = None,
        max_concurrent: int = 2,
        connection_factory: Optional[Callable] = None,
        dialect: str = "sqlite",
    ):
        """``connection_factory``/``dialect`` switch the backend: pass a
        zero-arg factory returning DB-API connections whose cursors yield
        mapping rows (psycopg2 ``RealDictCursor``) with
        ``dialect="postgresql"`` and every statement runs the PostgreSQL
        plan — %s placeholders and a single-statement
        ``FOR UPDATE SKIP LOCKED ... RETURNING`` claim.  ``db_path``
        defaults to ``scheduler.db`` under this process's temp directory."""
        import os
        import tempfile

        db_path = db_path or os.path.join(tempfile.gettempdir(), "marie", "scheduler.db")
        if connection_factory is None and db_path != ":memory:":
            os.makedirs(os.path.dirname(db_path) or ".", exist_ok=True)
        self.db_path = db_path
        self.dialect = dialect
        self.connection_factory = connection_factory
        self.logger = MarieLogger("SqlJobScheduler")
        self.job_handler = job_handler
        self.queue_names = queue_names or ["default"]
        self.max_concurrent = max_concurrent
        self._local = threading.local()
        self._running = False
        self._tasks: List[asyncio.Task] = []
        self._poll_interval = POLL_MIN
        self._active = 0
        conn = self._conn()
        with conn:
            for stmt in _SCHEMA.split(";"):
                if stmt.strip():
                    self._exec(conn, stmt)

    def _conn(self):
        conn = getattr(self._local, "conn", None)
        if conn is None:
            if self.connection_factory is not None:
                conn = self.connection_factory()
            else:
                conn = sqlite3.connect(self.db_path, timeout=30)
                conn.execute("PRAGMA journal_mode=WAL")
                conn.row_factory = sqlite3.Row
            self._local.conn = conn
        return conn

    def _exec(self, conn, sql: str, params=()):
        """Dialect-aware execute -> cursor (sqlite ?-style by default;
        postgres rewrites placeholders to %s and goes through cursor())."""
        if self.dialect == "postgresql":
            cur = conn.cursor()
            cur.execute(sql.replace("?", "%s"), params)
            return cur
        return conn.execute(sql, params)

    # ------------------------------------------------------------------
    async def start(self) -> None:
        self._running = True
        self._tasks = [
            asyncio.create_task(self._poll_loop()),
            asyncio.create_task(self._monitor_loop()),
        ]

    async def stop(self) -> None:
        self._running = False
        for t in self._tasks:
            t.cancel()
        self._tasks = []

    # ------------------------------------------------------------------
    async def submit_job(self, work_info: WorkInfo, **kwargs) -> str:
        conn = self._conn()
        if work_info.policy == ExistingWorkPolicy.REJECT_DUPLICATE:
            row = self._exec(conn, 
                "SELECT id FROM job WHERE name=? AND state IN ('created','retry','active')",
                (work_info.name,),
            ).fetchone()
            if row:
                raise ValueError(
                    f"duplicate job for queue {work_info.name} (policy=reject)"
                )
        self._exec(
            conn,
            "INSERT INTO job (id,name,priority,state,retry_limit,retry_count,"
            "retry_delay,retry_backoff,start_after,expire_in_seconds,data,"
            "created_on,dead_letter,keep_until) "
            "VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?,?)",
            (
                work_info.id,
                work_info.name,
                work_info.priority,
                WorkState.CREATED.value,
                work_info.retry_limit,
                work_info.retry_count,
                work_info.retry_delay,
                int(work_info.retry_backoff),
                work_info.start_after,
                work_info.expire_in_seconds,
                json.dumps(work_info.data),
                work_info.created_on,
                work_info.dead_letter,
                work_info.keep_until,
            ),
        )
        self._history(conn, work_info.id, WorkState.CREATED.value)
        conn.commit()
        self._poll_interval = POLL_MIN  # wake up fast after new work
        return work_info.id

    def _history(self, conn, job_id: str, state: str, detail: str = "") -> None:
        self._exec(
            conn,
            "INSERT INTO job_history (id,state,ts,detail) VALUES (?,?,?,?)",
            (job_id, state, time.time(), detail),
        )

    # ------------------------------------------------------------------
    def fetch_next(self, queue: str) -> Optional[WorkInfo]:
        """Atomically claim the next runnable job.

        PostgreSQL: a single-statement claim — subselect with
        ``FOR UPDATE SKIP LOCKED`` + ``RETURNING`` — so a poller that loses a race claims
        the NEXT candidate row instead of returning empty-handed.

        sqlite: SELECT + conditional UPDATE inside one transaction.
        sqlite has one writer at a time, so the conditional UPDATE is
        exactly equivalent; the rowcount==0 branch only fires across
        processes."""
        conn = self._conn()
        now = time.time()
        if self.dialect == "postgresql":
            with conn:
                cur = self._exec(
                    conn,
                    "UPDATE job SET state='active', started_on=? "
                    "WHERE id = (SELECT id FROM job WHERE name=? "
                    "AND state IN ('created','retry') AND start_after<=? "
                    "ORDER BY priority DESC, created_on LIMIT 1 "
                    "FOR UPDATE SKIP LOCKED) RETURNING *",
                    (now, queue, now),
                )
                row = cur.fetchone()
                if row is None:
                    return None
                self._history(conn, row["id"], WorkState.ACTIVE.value)
            return self._row_to_work(
                row, state=WorkState.ACTIVE, started_on=now
            )
        with conn:  # transaction
            row = self._exec(conn,
                "SELECT * FROM job WHERE name=? AND state IN ('created','retry') "
                "AND start_after<=? ORDER BY priority DESC, created_on LIMIT 1",
                (queue, now),
            ).fetchone()
            if row is None:
                return None
            cur = self._exec(conn,
                "UPDATE job SET state='active', started_on=? "
                "WHERE id=? AND state IN ('created','retry')",
                (now, row["id"]),
            )
            if cur.rowcount == 0:  # lost the race
                return None
            self._history(conn, row["id"], WorkState.ACTIVE.value)
        return self._row_to_work(row, state=WorkState.ACTIVE, started_on=now)

    def _archive_upsert_sql(self) -> str:
        if self.dialect == "postgresql":
            return (
                "INSERT INTO archive VALUES (?,?,?,?,?) "
                "ON CONFLICT (id) DO UPDATE SET state=excluded.state, "
                "data=excluded.data, archived_on=excluded.archived_on"
            )
        return "INSERT OR REPLACE INTO archive VALUES (?,?,?,?,?)"

    @staticmethod
    def _row_to_work(row, state=None, started_on=None) -> WorkInfo:
        return WorkInfo(
            id=row["id"],
            name=row["name"],
            priority=row["priority"],
            state=state or WorkState(row["state"]),
            retry_limit=row["retry_limit"],
            retry_count=row["retry_count"],
            retry_delay=row["retry_delay"],
            retry_backoff=bool(row["retry_backoff"]),
            start_after=row["start_after"],
            expire_in_seconds=row["expire_in_seconds"],
            data=json.loads(row["data"] or "{}"),
            created_on=row["created_on"],
            started_on=started_on or row["started_on"],
            completed_on=row["completed_on"],
            dead_letter=row["dead_letter"],
            keep_until=row["keep_until"] or 0.0,
            output=json.loads(row["output"]) if row["output"] else None,
        )

    # ------------------------------------------------------------------
    def complete_job(self, job_id: str, output: Any = None) -> None:
        conn = self._conn()
        with conn:
            self._exec(
                conn,
                "UPDATE job SET state='completed', completed_on=?, output=? "
                "WHERE id=?",
                (
                    time.time(),
                    json.dumps(output) if output is not None else None,
                    job_id,
                ),
            )
            self._history(conn, job_id, WorkState.COMPLETED.value)

    def fail_job(self, job_id: str, error: str = "") -> None:
        """Fail → retry when budget remains, else terminal failed (the
        payload re-enqueues on the job's dead-letter queue when one is
        configured, as pg-boss does)."""
        conn = self._conn()
        with conn:
            row = self._exec(conn, 
                "SELECT retry_count, retry_limit, retry_delay, retry_backoff "
                "FROM job WHERE id=?",
                (job_id,),
            ).fetchone()
            if row is None:
                return
            if row["retry_count"] < row["retry_limit"]:
                delay = row["retry_delay"] * (
                    2 ** row["retry_count"] if row["retry_backoff"] else 1
                )
                self._exec(
                    conn,
                    "UPDATE job SET state='retry', retry_count=retry_count+1, "
                    "start_after=? WHERE id=?",
                    (time.time() + delay, job_id),
                )
                self._history(conn, job_id, WorkState.RETRY.value, error)
            else:
                self._exec(
                    conn,
                    "UPDATE job SET state='failed', completed_on=?, output=? "
                    "WHERE id=?",
                    (time.time(), json.dumps({"error": error}), job_id),
                )
                self._history(conn, job_id, WorkState.FAILED.value, error)
                self._dead_letter(conn, job_id, error)

    def _dead_letter(self, conn, job_id: str, error: str) -> None:
        """Re-enqueue a terminal job's payload on its dead-letter queue
        with a fresh id and retry budget."""
        import uuid

        row = self._exec(conn, 
            "SELECT * FROM job WHERE id=?", (job_id,)
        ).fetchone()
        if row is None or not row["dead_letter"]:
            return
        dlq_id = uuid.uuid4().hex
        self._exec(
            conn,
            "INSERT INTO job (id,name,priority,state,retry_limit,retry_count,"
            "retry_delay,retry_backoff,start_after,expire_in_seconds,data,"
            "created_on,dead_letter,keep_until) "
            "VALUES (?,?,?,?,?,?,?,?,?,?,?,?,NULL,?)",
            (
                dlq_id,
                row["dead_letter"],
                row["priority"],
                WorkState.CREATED.value,
                row["retry_limit"],
                0,
                row["retry_delay"],
                row["retry_backoff"],
                0,
                row["expire_in_seconds"],
                row["data"],
                time.time(),
                row["keep_until"],
            ),
        )
        self._history(
            conn, dlq_id, WorkState.CREATED.value,
            f"dead-lettered from {job_id}: {error}",
        )
        self._poll_interval = POLL_MIN

    async def cancel_job(self, job_id: str) -> bool:
        conn = self._conn()
        with conn:
            cur = self._exec(conn, 
                "UPDATE job SET state='cancelled', completed_on=? "
                "WHERE id=? AND state NOT IN ('completed','failed')",
                (time.time(), job_id),
            )
            if cur.rowcount:
                self._history(conn, job_id, WorkState.CANCELLED.value)
        return bool(cur.rowcount)

    async def resume_job(self, job_id: str) -> bool:
        conn = self._conn()
        with conn:
            cur = self._exec(conn, 
                "UPDATE job SET state='created', start_after=0 "
                "WHERE id=? AND state IN ('cancelled','failed','expired')",
                (job_id,),
            )
            if cur.rowcount:
                self._history(conn, job_id, "resumed")
        self._poll_interval = POLL_MIN
        return bool(cur.rowcount)

    async def get_job(self, job_id: str) -> Optional[WorkInfo]:
        row = self._exec(
            self._conn(), "SELECT * FROM job WHERE id=?", (job_id,)
        ).fetchone()
        return self._row_to_work(row) if row else None

    async def list_jobs(self, state=None, limit: int = 100) -> List[WorkInfo]:
        conn = self._conn()
        if state is not None:
            rows = self._exec(conn, 
                "SELECT * FROM job WHERE state=? ORDER BY created_on DESC LIMIT ?",
                (state.value, limit),
            ).fetchall()
        else:
            rows = self._exec(conn, 
                "SELECT * FROM job ORDER BY created_on DESC LIMIT ?", (limit,)
            ).fetchall()
        return [self._row_to_work(r) for r in rows]

    def job_history(self, job_id: str) -> List[Dict[str, Any]]:
        rows = self._exec(
            self._conn(),
            "SELECT state, ts, detail FROM job_history WHERE id=? ORDER BY ts",
            (job_id,),
        ).fetchall()
        return [dict(r) for r in rows]

    # ------------------------------------------------------------------
    # cron schedules (pg-boss's schedule table)
    def schedule(self, name: str, cron: str, data: Optional[Dict] = None) -> None:
        """Enqueue a job on ``name`` every time ``cron`` matches (minute
        granularity, at most once per minute per schedule)."""
        cron_matches(cron, time.localtime())  # validate eagerly
        conn = self._conn()
        with conn:
            self._exec(
                conn,
                "INSERT INTO schedule (name,cron,data,created_on,updated_on) "
                "VALUES (?,?,?,?,?) ON CONFLICT(name) DO UPDATE SET "
                "cron=excluded.cron, data=excluded.data, "
                "updated_on=excluded.updated_on",
                (name, cron, json.dumps(data or {}), time.time(), time.time()),
            )

    def unschedule(self, name: str) -> bool:
        conn = self._conn()
        with conn:
            cur = self._exec(conn, "DELETE FROM schedule WHERE name=?", (name,))
        return bool(cur.rowcount)

    def schedules(self) -> List[Dict[str, Any]]:
        rows = self._exec(self._conn(), "SELECT * FROM schedule").fetchall()
        return [dict(r) for r in rows]

    def _run_schedules(self, now: Optional[float] = None) -> int:
        """Fire due schedules (called from the monitor loop); returns the
        number of jobs enqueued."""
        now = now if now is not None else time.time()
        minute = int(now // 60)
        t = time.localtime(now)
        conn = self._conn()
        fired = 0
        with conn:
            for row in self._exec(conn, "SELECT * FROM schedule").fetchall():
                if row["last_fired_minute"] == minute:
                    continue
                try:
                    due = cron_matches(row["cron"], t)
                except ValueError:
                    continue
                if not due:
                    continue
                cur = self._exec(conn, 
                    "UPDATE schedule SET last_fired_minute=? "
                    "WHERE name=? AND last_fired_minute!=?",
                    (minute, row["name"], minute),
                )
                if cur.rowcount == 0:  # another process fired this minute
                    continue
                import uuid

                job_id = uuid.uuid4().hex
                self._exec(
                    conn,
                    "INSERT INTO job (id,name,priority,state,retry_limit,"
                    "retry_count,retry_delay,retry_backoff,start_after,"
                    "expire_in_seconds,data,created_on,dead_letter,keep_until) "
                    "VALUES (?,?,0,?,2,0,1.0,1,0,0,?,?,NULL,0)",
                    (
                        job_id,
                        row["name"],
                        WorkState.CREATED.value,
                        row["data"],
                        now,
                    ),
                )
                self._history(
                    conn, job_id, WorkState.CREATED.value,
                    f"cron {row['cron']}",
                )
                fired += 1
        if fired:
            self._poll_interval = POLL_MIN
        return fired

    # ------------------------------------------------------------------
    async def _poll_loop(self) -> None:
        """Adaptive polling: 1.25s when busy, backing off to 16s idle."""
        while self._running:
            try:
                got_work = False
                for queue in self.queue_names:
                    while self._active < self.max_concurrent:
                        work = self.fetch_next(queue)
                        if work is None:
                            break
                        got_work = True
                        asyncio.create_task(self._run_job(work))
                self._poll_interval = (
                    POLL_MIN
                    if got_work
                    else min(self._poll_interval * 2, POLL_MAX)
                )
            except Exception as ex:  # noqa: BLE001
                self.logger.error(f"poll loop error: {ex!r}")
            await asyncio.sleep(self._poll_interval)

    async def _run_job(self, work: WorkInfo) -> None:
        self._active += 1
        try:
            if self.job_handler is None:
                self.complete_job(work.id)
                return
            ok = await self.job_handler(work)
            if ok:
                # non-boolean truthy results persist as the job's output
                self.complete_job(
                    work.id, output=None if ok is True else ok
                )
            else:
                self.fail_job(work.id, "handler returned falsy")
        except Exception as ex:  # noqa: BLE001
            self.fail_job(work.id, repr(ex))
        finally:
            self._active -= 1

    async def _monitor_loop(self) -> None:
        """Maintenance: expire overdue active jobs, archive old terminals."""
        while self._running:
            try:
                self._run_schedules()
                conn = self._conn()
                now = time.time()
                with conn:
                    rows = self._exec(conn, 
                        "SELECT id FROM job WHERE state='active' AND "
                        "expire_in_seconds>0 AND started_on+expire_in_seconds<?",
                        (now,),
                    ).fetchall()
                    for r in rows:
                        self._exec(
                            conn,
                            "UPDATE job SET state='expired', completed_on=? WHERE id=?",
                            (now, r["id"]),
                        )
                        self._history(conn, r["id"], WorkState.EXPIRED.value)
                        self._dead_letter(conn, r["id"], "expired")
                    # archive terminal jobs older than an hour, once past
                    # their keep_until retention mark (pg-boss keep_until)
                    old = self._exec(conn, 
                        "SELECT * FROM job WHERE state IN "
                        "('completed','failed','cancelled','expired') "
                        "AND completed_on < ? AND keep_until < ?",
                        (now - 3600, now),
                    ).fetchall()
                    for r in old:
                        self._exec(conn, self._archive_upsert_sql(),
                                   (r["id"], r["name"], r["state"],
                                    r["data"], now))
                        self._exec(
                            conn, "DELETE FROM job WHERE id=?", (r["id"],)
                        )
            except Exception as ex:  # noqa: BLE001
                self.logger.error(f"monitor loop error: {ex!r}")
            await asyncio.sleep(MONITOR_INTERVAL)
