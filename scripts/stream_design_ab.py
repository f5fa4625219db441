#!/usr/bin/env python3
"""A/B of how the engine's page-group streams are threaded, on the card.

    python3 scripts/stream_design_ab.py [--reps 5] [--rounds 3]

``device_thread`` is the engine's design: one kept thread uploads and
runs every stream's groups, in turns (``ocr/fused.py::_DeviceThread``).
``thread_per_stream`` is the design before it, kept here as the
baseline: each concurrent stream takes a kept worker thread of its own,
started when none is idle (:class:`_KeptWorkers`).  Both run a stream
``max_in_flight + 1`` groups ahead of its consumer, so only the
threading differs.  The designs take turns in the order device_thread,
thread_per_stream, thread_per_stream, device_thread, on three loads:

- ``trained``: ``chip_smoke.zoo_engine`` (the serving engine on the
  trained trees, chained heads) on the 16 shipped pages, one stream at a
  time: ms/page of each of ``--reps`` calls after a warm call;
- ``stream``: ``chip_smoke.phase_stream`` on the seeded heatmap serving
  engine (48 pages): pages/s and whether each group's collect began
  before the next group's device work ended;
- ``serve``: a fresh worker pod per turn (``TextExtractionExecutor``,
  the ``default`` engine, over HTTP) answers the 16 shipped pages as 8
  ``/document/extract`` requests of 2 pages one after another, then
  ``--rounds`` rounds of all 8 in flight: each request's ms and the
  executor's own seconds, p50/p95 and pages/s per round.  The first
  round with 8 in flight is the one where a thread per stream starts 7
  threads with no cuDNN/cuBLAS plans.

Prints one JSON line per measurement, then the card's name and power
limit.  Served words of every turn are checked equal to the first
turn's.
"""

import argparse
import json
import os
import queue
import statistics
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the pod's child imports the executor below as ``stream_design_ab``
sys.path[:0] = [ROOT, os.path.dirname(os.path.abspath(__file__))]

import torch  # noqa: E402

import marie_tpu_torch.ocr.fused as fused  # noqa: E402
import marie_tpu_torch.ocr.ocr_engine as ocr_engine  # noqa: E402
from marie_tpu_torch.executor.text_extraction_executor import (  # noqa: E402
    TextExtractionExecutor,
)

ORDER = ("device_thread", "thread_per_stream", "thread_per_stream", "device_thread")
PAIRS = 8  # requests of 2 pages: the 16 shipped pages


class _KeptWorkers:
    """The streams' worker threads, kept and reused: a stream takes an
    idle worker or starts a new one."""

    def __init__(self):
        self._lock = threading.Lock()
        self._idle: List["queue.SimpleQueue"] = []

    def run(self, job, done) -> None:
        with self._lock:
            jobs = self._idle.pop() if self._idle else None
        if jobs is None:
            jobs = queue.SimpleQueue()
            threading.Thread(target=self._serve, args=(jobs,), daemon=True).start()
        jobs.put((job, done))

    def _serve(self, jobs: "queue.SimpleQueue") -> None:
        while True:
            job, done = jobs.get()
            job()
            with self._lock:
                self._idle.append(jobs)
            done()


_WORKERS = _KeptWorkers()


def thread_per_stream(box_processor, ocr_processor, images, rec_slots: int = 256,
                      page_batch: int = 4, compact_slots: int = 192, max_in_flight: int = 4,
                      upload_format: str = "u8", mesh=None, chain=None):
    """``fused.fused_dispatch_stream`` with the stream's groups on a
    worker thread of its own, which runs a group and then waits for room
    among ``max_in_flight`` handles."""
    from marie_tpu_torch.ocr.fused_chain import fused_ocr_chain

    if mesh is not None or upload_format not in fused.UPLOAD_FORMATS:
        raise ValueError("the baseline takes the engine's own settings only")
    bp, op = box_processor, ocr_processor
    device = bp.device
    preps = [bp.prep_page(im) for im in images]
    groups = fused._plan_groups(preps, page_batch)
    q: "queue.SimpleQueue" = queue.SimpleQueue()
    slots = threading.Semaphore(max(max_in_flight, 1))

    def _work():
        try:
            if device.type == "cuda" and device.index is not None:
                torch.cuda.set_device(device)
            for group in groups:
                pages, clip, psize, packed = fused._upload_group(
                    preps, group, page_batch, upload_format, device)
                total_slots = psize * compact_slots
                heads = None
                if chain is None:
                    stats, tokens, conf = fused.fused_ocr_pages(
                        bp, op, pages, clip, n_real=len(group), total_slots=total_slots,
                        packed=packed)
                else:
                    stats, tokens, conf, *heads = fused_ocr_chain(
                        bp, op, *chain, pages, clip, n_real=len(group),
                        total_slots=total_slots, packed=packed)
                    heads = tuple(fused._to_host(t) for t in heads)
                stats = {k: fused._to_host(v) for k, v in stats.items()}
                tokens, conf = fused._to_host(tokens), fused._to_host(conf)
                ready = None
                if device.type == "cuda":
                    ready = torch.cuda.Event(enable_timing=True)
                    ready.record()
                metas = [(preps[k][1], preps[k][2]) for k in group]
                slots.acquire()
                q.put(("ok", fused.GroupHandle(stats, tokens, conf, pages, packed, metas,
                                               total_slots, ready, heads)))
        except BaseException as exc:  # noqa: BLE001 — raised in the caller
            q.put(("err", exc))

    _WORKERS.run(_work, lambda: q.put(("end", None)))
    while True:
        kind, val = q.get()
        if kind == "end":
            return
        if kind == "err":
            raise val
        slots.release()
        yield val


_DESIGNS = {"device_thread": fused.fused_dispatch_stream,
            "thread_per_stream": thread_per_stream}


def use_design(name: str) -> None:
    """Route the engine's streams (and ``fused_dispatch_many``) through
    the design ``name``."""
    fused.fused_dispatch_stream = ocr_engine.fused_dispatch_stream = _DESIGNS[name]


class ThreadPerStreamExecutor(TextExtractionExecutor):
    """The served text-extraction executor with the baseline's streams."""

    def __init__(self, **kwargs):
        use_design("thread_per_stream")
        super().__init__(**kwargs)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def engine_loads(chip_smoke, shipped, design: str, reps: int) -> None:
    from marie_tpu_torch.models.configs import CraftConfig
    from marie_tpu_torch.registry.convert import init_flax_layout

    use_design(design)
    engine = chip_smoke.zoo_engine("cuda")
    pages = list(shipped["pages"])
    engine.extract(pages)
    torch.cuda.synchronize()
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        engine.extract(pages)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) / len(pages) * 1e3)
    emit({"load": "trained", "design": design, "ms_per_page": ms,
          "median_ms_per_page": statistics.median(ms)})
    del engine
    drawn = chip_smoke.draw_pages(chip_smoke.SLICE_PAGES, 1024, 768, chip_smoke.SEED + 3)
    bp = chip_smoke.serving_detector(
        "heatmap", drawn, init_flax_layout(CraftConfig.fast_s2d2(), chip_smoke.SEED))
    engine = chip_smoke.serving_engine(bp, chip_smoke.serving_recognizer())
    engine.extract(drawn)
    rows = []
    chip_smoke.emit = rows.append
    for _ in range(reps):
        chip_smoke.phase_stream(engine, drawn)
    emit({"load": "stream", "design": design,
          "pages_per_s": [r["pages_per_s"] for r in rows],
          "median_pages_per_s": statistics.median(r["pages_per_s"] for r in rows),
          "overlap": [r["collect_began_before_next_group_ended"] for r in rows]})
    use_design("device_thread")


def serve_load(shipped, design: str, rounds: int, work_dir: str):
    """(row, the served words) of one pod's turn."""
    from marie_tpu_torch.clients import HTTPClient
    from marie_tpu_torch.orchestrate.pods import Pod
    from marie_tpu_torch.types import Document

    uses = ("marie_tpu_torch.executor.TextExtractionExecutor" if design == "device_thread"
            else "stream_design_ab.ThreadPerStreamExecutor")
    pages = list(shipped["pages"])
    pairs = [pages[2 * i:2 * i + 2] for i in range(PAIRS)]
    pod = Pod("worker", uses=uses, protocol="http", name="extract",
              uses_with={"ocr_engine": "default", "device": "cuda",
                         "work_dir": os.path.join(work_dir, design)})
    t0 = time.perf_counter()
    pod.start()
    row = {"load": "serve", "design": design, "startup_s": time.perf_counter() - t0}

    def request(pair, i, client=None):
        """(request ms, the executor's seconds, OCR words) of one request."""
        c = client or HTTPClient(port=pod.port)
        try:
            t = time.perf_counter()
            body = c.post("/document/extract",
                          [Document(id=f"p{i}-{k}", tensor=p) for k, p in enumerate(pair)],
                          parameters={"ref_id": f"pair-{i}", "job_id": f"job-{i}"},
                          return_responses=True)
            ms = (time.perf_counter() - t) * 1e3
        finally:
            if client is None:
                c.close()
        env = body["parameters"]["__results__"]["extract"]
        if env.get("status") != "succeeded":
            raise AssertionError(f"{design} request {i}: {env}")
        words = [[(wd["text"], tuple(wd["box"])) for wd in page["words"]]
                 for page in env["metadata"]["ocr"]]
        return ms, env["runtime_info"]["elapsed"], words

    try:
        client = HTTPClient(port=pod.port)
        seq = [request(pair, i, client) for i, pair in enumerate(pairs)]
        client.close()
        row["sequential_ms"] = [ms for ms, _, _ in seq]
        row["concurrent"] = []
        for _ in range(rounds):
            with ThreadPoolExecutor(PAIRS) as pool:
                t0 = time.perf_counter()
                res = list(pool.map(request, pairs, range(PAIRS), timeout=900))
                wall = time.perf_counter() - t0
            ms = [m for m, _, _ in res]
            row["concurrent"].append({
                "pages_per_s": len(pages) / wall, "p50_ms": statistics.median(ms),
                "p95_ms": sorted(ms)[min(round(0.95 * (len(ms) - 1)), len(ms) - 1)],
                "request_ms": ms, "executor_s": [e for _, e, _ in res],
                "words_equal_sequential": [w for _, _, w in res] == [w for _, _, w in seq]})
    finally:
        pod.close(timeout=10.0)
    emit(row)
    if not all(r["words_equal_sequential"] for r in row["concurrent"]):
        raise AssertionError(f"{design}: concurrent words differ from sequential")
    return row, [w for _, _, w in seq]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("stream_design_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from marie_tpu_torch.utils.device import card_name_and_power_limit

    shipped = chip_smoke.load_shipped()
    for design in ORDER:
        engine_loads(chip_smoke, shipped, design, args.reps)
    words = None
    with tempfile.TemporaryDirectory() as work_dir:
        for design in ORDER:
            _, got = serve_load(shipped, design, args.rounds, work_dir)
            if words is None:
                words = got
            elif got != words:
                raise AssertionError(f"{design}: served words differ from the first turn's")
    print(card_name_and_power_limit(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
