"""Hot reload of a worker's executor and the render layer of the live
console, against the JAX package's.

Hot reload: each package's handler serves an executor from a module in a
temporary directory (the same body on each package's ``BaseExecutor``);
an edit changes both answers, a broken edit keeps both on the old code,
and a fixed one is taken up.  The console: the same snapshot renders the
same dashboard, result viewer and help lines in both packages (the cases
of ``tests/unit/test_ctl_tui.py``)."""

import asyncio
import os
import sys
import textwrap
import time

import pytest

_BODY = """
from {pkg}.serve.executors import BaseExecutor
from {pkg}.serve.executors.decorators import requests

class VersionedExecutor(BaseExecutor):
    @requests(on="/v")
    def version(self, docs, **kwargs):
        for d in docs:
            d.text = "v1"
        return docs
"""


def _touch(path, text):
    """Write ``text`` with an mtime past the last one (a poll sees it)."""
    before = os.path.getmtime(path)
    path.write_text(text)
    os.utime(path, (before + 5,) * 2)


def test_hot_reload_swaps_and_keeps_serving_as_jax(tmp_path):
    import importlib

    from marie_tpu.serve.runtimes.worker.request_handling import (
        WorkerRequestHandler as JWorkerRequestHandler)
    from marie_tpu.types.docs import Document as JDocument
    from marie_tpu.types.docs import DocumentArray as JDocumentArray
    from marie_tpu.types.request import DataRequest as JDataRequest
    from marie_tpu_torch.serve.runtimes.worker.request_handling import WorkerRequestHandler
    from marie_tpu_torch.types.docs import Document, DocumentArray
    from marie_tpu_torch.types.request import DataRequest

    sides = {"port": ("marie_tpu_torch", WorkerRequestHandler, DataRequest, DocumentArray,
                      Document),
             "jax": ("marie_tpu", JWorkerRequestHandler, JDataRequest, JDocumentArray,
                     JDocument)}
    files, handlers = {}, {}
    sys.path.insert(0, str(tmp_path))
    try:
        for side, (pkg, handler_cls, *_rest) in sides.items():
            mod_dir = tmp_path / f"hotmod_{side}"
            mod_dir.mkdir()
            (mod_dir / "__init__.py").write_text("")
            files[side] = mod_dir / "exec_v.py"
            files[side].write_text(textwrap.dedent(_BODY.format(pkg=pkg)))
            mod = importlib.import_module(f"hotmod_{side}.exec_v")
            handlers[side] = handler_cls(executor=mod.VersionedExecutor(), name="hot")

        async def answers():
            out = {}
            for side, (_, _, request_cls, da_cls, doc_cls) in sides.items():
                req = request_cls.from_docs(da_cls([doc_cls()]), "/v")
                out[side] = (await handlers[side].process_data([req])).docs[0].text
            return out

        async def until(want, timeout=10.0):
            deadline = time.time() + timeout
            got = await answers()
            while got != want and time.time() < deadline:
                await asyncio.sleep(0.1)
                got = await answers()
            return got

        async def drive():
            tasks = [handlers["port"].start_hot_reload(interval=0.1),
                     asyncio.create_task(handlers["jax"]._hot_reload_loop(interval=0.1))]
            steps = [await answers()]
            for side in sides:
                _touch(files[side], files[side].read_text().replace('"v1"', '"v2"'))
            steps.append(await until({"port": "v2", "jax": "v2"}))
            for side in sides:  # a broken edit: the old code keeps serving
                _touch(files[side], files[side].read_text().replace("def version", "def version("))
            await asyncio.sleep(0.6)
            steps.append(await answers())
            for side in sides:  # fixed: taken up
                _touch(files[side], textwrap.dedent(_BODY.format(pkg=sides[side][0]))
                       .replace('"v1"', '"v3"'))
            steps.append(await until({"port": "v3", "jax": "v3"}))
            await handlers["port"].close()  # close ends the poll
            tasks[1].cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            assert tasks[0].cancelled()
            return steps

        steps = asyncio.run(drive())
    finally:
        sys.path.remove(str(tmp_path))
    assert steps == [{"port": v, "jax": v} for v in ("v1", "v2", "v2", "v3")]


def test_hot_reload_starts_on_a_running_loop_only():
    from marie_tpu_torch.serve.executors import BaseExecutor
    from marie_tpu_torch.serve.runtimes.worker.request_handling import WorkerRequestHandler

    handler = WorkerRequestHandler(executor=BaseExecutor(), hot_reload=True)
    assert handler._reload_task is None  # no loop here: start_hot_reload starts it

    async def on_a_loop():
        h = WorkerRequestHandler(executor=BaseExecutor(), hot_reload=True)
        started = h._reload_task is not None and h.start_hot_reload() is h._reload_task
        await h.close()
        return started

    assert asyncio.run(on_a_loop())


JOBS = [{"id": "a" * 32, "name": "extract", "state": "completed", "created_on": 1767000000.0,
         "output": {"pages": 3}},
        {"id": "b" * 32, "name": "classify", "state": "active", "created_on": 1767000100.0}]


def _snaps():
    from marie_tpu_server import ctl as jctl
    from marie_tpu_torch.server import ctl

    kw = dict(ok=True, gateway="127.0.0.1:51000", deployments={"extract_t": ["h:1", "h:2"]},
              jobs=list(JOBS), events=[{"event": "started", "jobid": "a" * 32}],
              fetched_at=1767000200.0)
    return (ctl, ctl.Snapshot(**kw)), (jctl, jctl.Snapshot(**kw))


@pytest.mark.parametrize("w,h,selected", [(80, 24, 1), (60, 10, 0), (120, 40, 0), (40, 6, 1)])
def test_dashboard_renders_as_jax(w, h, selected):
    (ctl, snap), (jctl, jsnap) = _snaps()
    lines = ctl.render_dashboard(snap, w=w, h=h, selected=selected, server="x:1")
    assert lines == jctl.render_dashboard(jsnap, w=w, h=h, selected=selected, server="x:1")
    assert len(lines) == h and all(len(ln) == w for ln in lines)
    if h >= 24:
        marked = [ln for ln in lines if ln.startswith(">")]
        assert len(marked) == 1 and ("b" if selected else "a") * 8 in marked[0]
        assert any("extract_t" in ln and "replicas=2" in ln for ln in lines)
    down = ctl.render_dashboard(ctl.Snapshot(ok=False, error="ConnectionRefusedError()"),
                                w=w, h=h, selected=0, server="x:1")
    assert down[2:] == jctl.render_dashboard(
        jctl.Snapshot(ok=False, error="ConnectionRefusedError()"), w=w, h=h, selected=0,
        server="x:1")[2:]
    assert any("unreachable" in ln for ln in down)


def test_result_viewer_and_help_render_as_jax():
    (ctl, _), (jctl, _) = _snaps()
    for job in JOBS:
        for w, h, scroll in ((60, 8, 0), (60, 8, 3), (60, 30, 0), (30, 5, 10 ** 6)):
            got = ctl.render_result(job, w, h, scroll)
            assert got == jctl.render_result(job, w, h, scroll)
            assert len(got) == h and all(len(ln) == w for ln in got)
    assert ctl.render_result(JOBS[0], 60, 8, 0) != ctl.render_result(JOBS[0], 60, 8, 3)
    for w, h in ((50, 20), (20, 4)):
        assert ctl.render_help(w, h) == jctl.render_help(w, h)
    assert ctl.KEYBINDINGS == jctl.KEYBINDINGS
