"""The job control plane's parts held to the JAX package's on the same
calls: the SQL scheduler (the cases of ``tests/core/test_scheduler.py``),
the job manager (``tests/core/test_job_manager.py``), the Toast bus and
its JSONL and sqlite handlers, the dataclass models against the pydantic
ones, and the payload parser (``tests/unit/test_api_payload.py``).

Each scenario runs once against each package's modules and returns what
it observed (ids and times masked); the two must be equal."""

import asyncio
import base64
import io
import json
import os
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest


def _port():
    import marie_tpu_torch.scheduler.sql as sql
    from marie_tpu_torch.enums import JobStatus, WorkState
    from marie_tpu_torch.excepts import JobNotFoundError
    from marie_tpu_torch.job.common import JobInfo
    from marie_tpu_torch.job.job_manager import JobManager
    from marie_tpu_torch.messaging import Toast, publisher
    from marie_tpu_torch.messaging.native_handler import NativeToastHandler
    from marie_tpu_torch.messaging.sqlite_handler import SqliteToastHandler
    from marie_tpu_torch.scheduler.models import ExistingWorkPolicy, WorkInfo
    from marie_tpu_torch.storage.kv.in_memory import InMemoryKV

    return SimpleNamespace(**locals())


def _jax():
    import marie_tpu.scheduler.sql as sql
    from marie_tpu.enums import JobStatus, WorkState
    from marie_tpu.excepts import JobNotFoundError
    from marie_tpu.job.common import JobInfo
    from marie_tpu.job.job_manager import JobManager
    from marie_tpu.messaging import Toast, publisher
    from marie_tpu.messaging.native_handler import NativeToastHandler
    from marie_tpu.messaging.sqlite_handler import SqliteToastHandler
    from marie_tpu.scheduler.models import ExistingWorkPolicy, WorkInfo
    from marie_tpu.storage.kv.in_memory import InMemoryKV

    return SimpleNamespace(**locals())


def _both(scenario, tmp_path):
    """(port's observation, JAX's) of one scenario, each in a directory of
    its own."""
    out = []
    for name, mods in (("port", _port()), ("jax", _jax())):
        d = tmp_path / name
        d.mkdir()
        out.append(asyncio.run(scenario(mods, d)))
    return out


# --- the scheduler ------------------------------------------------------------------

async def _submit_fetch_priority(m, d):
    s = m.sql.SqlJobScheduler(str(d / "s.db"))
    job_id = await s.submit_job(m.WorkInfo(name="q1", data={"x": 1}))
    got = s.fetch_next("q1")
    out = [got.id == job_id, got.state.value, got.data, s.fetch_next("q1")]
    await s.submit_job(m.WorkInfo(name="q", priority=0))
    high = await s.submit_job(m.WorkInfo(name="q", priority=5))
    out.append(s.fetch_next("q").id == high)
    await s.submit_job(m.WorkInfo(name="later", start_after=time.time() + 60))
    out.append(s.fetch_next("later"))
    await s.submit_job(m.WorkInfo(name="uniq"))
    try:
        await s.submit_job(m.WorkInfo(name="uniq", policy=m.ExistingWorkPolicy.REJECT_DUPLICATE))
        out.append("accepted")
    except ValueError as ex:
        out.append(str(ex))
    return out


async def _complete_fail_retry(m, d):
    s = m.sql.SqlJobScheduler(str(d / "s.db"))
    out = []
    job_id = await s.submit_job(m.WorkInfo(name="q"))
    s.fetch_next("q")
    s.complete_job(job_id, output={"pages": 3})
    job = await s.get_job(job_id)
    out += [job.state.value, job.output, [h["state"] for h in s.job_history(job_id)]]
    job_id = await s.submit_job(m.WorkInfo(name="r", retry_limit=2, retry_delay=0.0,
                                           retry_backoff=False))
    for _ in range(2):
        out.append(s.fetch_next("r") is not None)
        s.fail_job(job_id, "boom")
        out.append((await s.get_job(job_id)).state.value)
    s.fetch_next("r")
    s.fail_job(job_id, "boom-final")
    job = await s.get_job(job_id)
    out += [job.state.value, job.output, job.retry_count,
            [(h["state"], h["detail"]) for h in s.job_history(job_id)]]
    return out


async def _cancel_resume_dead_letter(m, d):
    s = m.sql.SqlJobScheduler(str(d / "s.db"))
    out = []
    job_id = await s.submit_job(m.WorkInfo(name="q"))
    out += [await s.cancel_job(job_id), (await s.get_job(job_id)).state.value,
            s.fetch_next("q"), await s.resume_job(job_id), s.fetch_next("q").id == job_id,
            await s.cancel_job("missing")]
    job_id = await s.submit_job(m.WorkInfo(name="d", data={"k": "v"}, retry_limit=0,
                                           dead_letter="d-dlq"))
    s.fetch_next("d")
    s.fail_job(job_id, "boom")
    dlq = s.fetch_next("d-dlq")
    detail = s.job_history(dlq.id)[0]["detail"]
    out += [(await s.get_job(job_id)).state.value, dlq.id != job_id, dlq.data, dlq.retry_count,
            dlq.dead_letter, detail.replace(job_id, "<id>")]
    return out


async def _schedules(m, d):
    s = m.sql.SqlJobScheduler(str(d / "s.db"))
    out = []
    s.schedule("nightly", "* * * * *", data={"task": "sweep"})
    now = float((int(time.time()) // 60) * 60 + 1)
    out += [[x["name"] for x in s.schedules()], s._run_schedules(now),
            s._run_schedules(now + 1), s._run_schedules(now + 61)]
    got = s.fetch_next("nightly")
    out += [got.data, s.job_history(got.id)[0]["detail"], s.unschedule("nightly"),
            s._run_schedules(now + 300), s.unschedule("nightly")]
    try:
        s.schedule("bad", "not a cron")
    except ValueError as ex:
        out.append(str(ex))
    s.schedule("s1", "0 9 * * *")
    s.schedule("s1", "0 10 * * *")
    out.append([(x["name"], x["cron"], x["data"]) for x in s.schedules()])
    t = time.struct_time((2026, 8, 18, 14, 30, 0, 1, 230, -1))
    out.append([m.sql.cron_matches(e, t) for e in (
        "* * * * *", "30 14 * * *", "31 14 * * *", "*/15 * * * *", "*/7 * * * *",
        "30 14 18 8 *", "30 14 19 8 *", "* * * * 2", "* * * * 0", "0-45 9-17 * * 1-5")])
    return out


async def _poll_loop_and_listing(m, d):
    done = []

    async def handler(work):
        done.append(work.data)
        return {"ok": True} if work.data.get("out") else True

    old = m.sql.POLL_MIN
    m.sql.POLL_MIN = 0.05
    s = m.sql.SqlJobScheduler(str(d / "s.db"), job_handler=handler)
    try:
        await s.start()
        ids = [await s.submit_job(m.WorkInfo(name="default", data={"i": i, "out": i == 1}))
               for i in range(2)]
        for _ in range(100):
            jobs = [await s.get_job(j) for j in ids]
            if all(j.state == m.WorkState.COMPLETED for j in jobs):
                break
            await asyncio.sleep(0.05)
    finally:
        await s.stop()
        m.sql.POLL_MIN = old
    listed = await s.list_jobs()
    dumped = [w.model_dump(mode="json") for w in listed]
    masked = [{k: ("<t>" if k in ("id", "created_on", "started_on", "completed_on") else v)
               for k, v in w.items()} for w in dumped]
    return [sorted(json.dumps(x, sort_keys=True) for x in done), masked,
            [list(w) for w in dumped],
            [w.state.value for w in await s.list_jobs(state=m.WorkState.COMPLETED)]]


async def _contention(m, d):
    db = str(d / "shared.db")
    a, b = m.sql.SqlJobScheduler(db), m.sql.SqlJobScheduler(db)
    for i in range(10):
        await a.submit_job(m.WorkInfo(name="q", data={"i": i}))
    claimed = []
    lock = threading.Lock()

    def worker(s):
        while True:
            got = s.fetch_next("q")
            if got is None:
                return
            with lock:
                claimed.append(got.data["i"])

    threads = [threading.Thread(target=worker, args=(s,)) for s in (a, b, a, b)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    return sorted(claimed)


async def _models(m, d):
    w = m.WorkInfo(name="q", priority="3", retry_backoff=0, keep_until=5, start_after=1,
                   data={"a": [1, 2]})
    dump = w.model_dump(mode="json")
    row = w.to_row()
    info = m.JobInfo(entrypoint="/x", metadata={"k": 1}, start_time=3)
    back = m.JobInfo.from_json(info.to_json())
    return [{k: v for k, v in dump.items() if k not in ("id", "created_on")},
            {k: (type(v).__name__, v) for k, v in row.items() if k not in ("id", "created_on")},
            type(w.model_dump()["state"]).__name__, w.state.is_terminal,
            json.loads(info.to_json()), back.status.value, back.start_time,
            [s.value for s in m.JobStatus if s.is_terminal],
            [s.value for s in m.WorkState if s.is_terminal]]


SCHEDULER_CASES = [_submit_fetch_priority, _complete_fail_retry, _cancel_resume_dead_letter,
                   _schedules, _poll_loop_and_listing, _contention, _models]


@pytest.mark.parametrize("scenario", SCHEDULER_CASES, ids=lambda f: f.__name__.strip("_"))
def test_scheduler_equals_jax(scenario, tmp_path):
    port, jax = _both(scenario, tmp_path)
    assert port == jax


# --- the job manager and Toast ----------------------------------------------------------

async def _status(mgr, job_id, want, timeout=5.0):
    for _ in range(int(timeout / 0.02)):
        if await mgr.get_job_status(job_id) == want:
            return True
        await asyncio.sleep(0.02)
    return False


async def _job_manager(m, d):
    events = []

    class Recorder:
        def notify(self, event, notification, **kw):
            events.append((event, notification["job_id"], notification["status"],
                           notification["payload"], sorted(notification)))

    recorder = Recorder()
    native = m.NativeToastHandler(str(d / "events.jsonl"))
    sqlite = m.SqliteToastHandler(str(d / "events.db"))
    m.Toast.register(recorder)
    m.Toast.register(native, native=True, event="job.")
    m.Toast.register(sqlite, event="job.completed")
    out = []
    try:
        async def ok(job_id, info):
            return {"ok": True, "entry": info.entrypoint}

        async def boom(job_id, info):
            raise RuntimeError("exploded")

        mgr = m.JobManager(m.InMemoryKV(), job_distributor=ok)
        job_id = await mgr.submit_job(entrypoint="/extract", submission_id="j1",
                                      metadata={"m": 1})
        out.append(await _status(mgr, job_id, m.JobStatus.SUCCEEDED))
        info = await mgr.job_info_client.get_info(job_id)
        out += [info.entrypoint, info.metadata, info.start_time is not None,
                info.end_time is not None, info.status.value]
        try:
            await mgr.submit_job(entrypoint="/x", submission_id="j1")
        except ValueError as ex:
            out.append(str(ex))
        mgr.job_distributor = boom
        job_id = await mgr.submit_job(entrypoint="/x", submission_id="j2")
        out.append(await _status(mgr, job_id, m.JobStatus.FAILED))
        out.append((await mgr.job_info_client.get_info(job_id)).message)

        started = asyncio.Event()

        async def slow(job_id, info):
            started.set()
            await asyncio.sleep(30)

        mgr = m.JobManager(m.InMemoryKV(), job_distributor=slow, max_slots=1)
        job_id = await mgr.submit_job(entrypoint="/slow", submission_id="j3")
        await asyncio.wait_for(started.wait(), 5)
        out += [mgr.has_available_slot(), await mgr.stop_job(job_id),
                (await mgr.get_job_status(job_id)).value, await mgr.stop_job(job_id)]
        try:
            await mgr.get_job_status("nope")
        except m.JobNotFoundError as ex:
            out.append(("not found", str(ex)))
        await mgr.job_info_client.put_info("ghost", m.JobInfo(status=m.JobStatus.RUNNING,
                                                              entrypoint="/x"))
        await mgr.recover_running_jobs()
        out.append((await mgr.get_job_status("ghost")).value)
        out.append(sorted(await mgr.list_jobs()))
        out.append(await mgr.delete_job("j3"))
        out.append(sorted(await mgr.list_jobs()))
        await m.publisher.mark_as_failed("j9", event_name="extract", payload={"e": 1})
    finally:
        m.Toast.unregister_all()
    with open(d / "events.jsonl") as f:
        jsonl = [(e["event"], e["job_id"], e["status"]) for e in map(json.loads, f)]
    stored = [(e["event"], e["job_id"], e["payload"]) for e in sqlite.events_for("j1")]
    return out, events, jsonl, stored


def test_job_manager_and_toast_equal_jax(tmp_path):
    port, jax = _both(_job_manager, tmp_path)
    assert port == jax
    assert [e[0] for e in port[1]][:3] == ["job.scheduled", "job.started", "job.completed"]


def test_default_paths_lie_under_the_temp_directory(tmp_path, monkeypatch):
    """The handlers', the scheduler's and the share's defaults follow the
    process's temp directory, so two checkouts with their own TMPDIR never
    write to one file."""
    import tempfile

    from marie_tpu_torch.api.payload import get_share_directory

    p = _port()
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.delenv("MARIE_SHARE_DIR", raising=False)
    native = p.NativeToastHandler()
    native.notify("job.started", {"job_id": "j1"})
    sqlite = p.SqliteToastHandler()
    sqlite.notify("job.started", {"job_id": "j1"})
    scheduler = p.sql.SqlJobScheduler()
    assert native.path == str(tmp_path / "marie" / "events.jsonl")
    assert os.path.exists(native.path)
    assert sqlite.db_path == str(tmp_path / "marie" / "events.db")
    assert scheduler.db_path == str(tmp_path / "marie" / "scheduler.db")
    assert get_share_directory() == str(tmp_path / "marie-share")


# --- the payload parser ---------------------------------------------------------------

def _png(w=40, h=30, color=(255, 0, 0)):
    from PIL import Image

    buf = io.BytesIO()
    Image.new("RGB", (w, h), color).save(buf, format="PNG")
    return buf.getvalue()


def _tiff(pages=3):
    from PIL import Image

    buf = io.BytesIO()
    imgs = [Image.new("RGB", (40, 30), (i * 40, 0, 0)) for i in range(pages)]
    imgs[0].save(buf, format="TIFF", save_all=True, append_images=imgs[1:])
    return buf.getvalue()


def _other(fmt):
    from PIL import Image

    buf = io.BytesIO()
    Image.new("RGB", (8, 8), (10, 20, 30)).save(buf, format=fmt)
    return buf.getvalue()


def test_payload_parser_equals_jax(tmp_path, monkeypatch):
    from marie_tpu.api import payload as jp
    from marie_tpu_torch.api import payload as tp

    monkeypatch.setenv("MARIE_SHARE_DIR", str(tmp_path))
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "doc.png").write_bytes(_png())
    (tmp_path / "remote.tif").write_bytes(_tiff(2))
    b64 = base64.b64encode
    for data in (_png(), _tiff(), _other("JPEG"), _other("BMP"), _other("GIF"), b"plain text"):
        assert tp.sniff_file_type(data) == jp.sniff_file_type(data)
    raw = b64(b"hello").decode()
    for s in (raw, f"data:image/png;base64,{raw}", raw[:4] + "\n" + raw[4:]):
        assert tp.base64_to_bytes(s) == jp.base64_to_bytes(s) == b"hello"
    payloads = [
        {"data": b64(_png()).decode()},
        {"srcData": b64(_png(17, 9, (1, 2, 3))).decode()},
        {"srcBase64": b64(_png()).decode()},
        {"data": b64(_tiff()).decode()},
        {"srcFile": "sub/doc.png"},
        {"uri": str(tmp_path / "remote.tif")},
    ]
    for i, payload in enumerate(payloads):
        frames, checksum, ftype = tp.parse_payload_to_frames(payload, f"port-{i}")
        jframes, jchecksum, jftype = jp.parse_payload_to_frames(payload, f"jax-{i}")
        assert (checksum, ftype) == (jchecksum, jftype)
        assert len(frames) == len(jframes)
        for a, b in zip(frames, jframes):
            np.testing.assert_array_equal(a, b)
    errors = [{"something": 1}, {"data": b64(b"plain text").decode()},
              {"srcFile": "../../etc/passwd"}, {"srcFile": "missing.png"},
              {"srcUrl": str(tmp_path / "nope.png")}]
    for payload in errors:
        with pytest.raises(Exception) as got:
            tp.extract_payload(payload, "q")
        with pytest.raises(Exception) as want:
            jp.extract_payload(payload, "q")
        assert type(got.value).__name__ == type(want.value).__name__
        assert str(got.value) == str(want.value)
    payload = {"a": 1, "args": {"b": 2}}
    for key, default in (("a", None), ("b", None), ("c", 3)):
        assert tp.value_from_payload_or_args(payload, key, default) == \
            jp.value_from_payload_or_args(payload, key, default)
    png = _png()
    path, digest = tp.store_temp_file(png, "qq", "png", store_raw=True)
    assert open(path, "rb").read() == png
    path2, digest2 = tp.store_temp_file(png, "qq2", "png", store_raw=False)
    assert digest == digest2 == jp.store_temp_file(png, "jq", "png", store_raw=False)[1]
    from marie_tpu_torch.utils.image_io import read_png

    np.testing.assert_array_equal(read_png(path2), read_png(path))
    # a format the port does not read (PIL does): ValueError, as ROADMAP §3 lists
    with pytest.raises(ValueError):
        tp.parse_payload_to_frames({"data": b64(_other("GIF")).decode()}, "q")
    assert len(jp.parse_payload_to_frames({"data": b64(_other("GIF")).decode()}, "q")[0]) == 1
    assert os.path.isdir(os.path.join(__import__("tempfile").gettempdir(), "marie"))
