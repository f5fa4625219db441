"""The warm-up before a worker serves (counterpart of
``marie_tpu/utils/program_zoo.py``'s ``prewarm``).

The JAX server loads its compiled serving programs before the first
request.  The port compiles nothing at run time; what a fresh worker pays
on its first request is the first use of the CUDA context, the kernel
libraries, cuDNN's plans and cuBLAS's handles.  :func:`prewarm` pays it
before readiness: it runs the served executor's programs once, at the
served shapes:

* an OCR executor's engine (``executor.pipeline.ocr_engine``, or
  ``executor.ocr_engine``) on WARMUP_PAGES drawn pages of WARMUP_PAGE_HW,
  one page group of the registry engine as the served 2-page requests
  give it; the engine streams the group through ``fused_dispatch_stream``
  on its kept device thread (``ocr/fused.py::_DEVICE``);
* a NER executor's reading-order model and indexer on one drawn page of
  WARMUP_WORDS words.

The kernels' launches of the warm-up are taken out of the process's
request counts (``_build.launch_counts``) and kept apart
(:func:`warmup_report`): ``/metrics`` and a worker's status show them
separately.  A warm-up that raises is not caught: the pod fails its start.

The switch is the JAX package's ``MARIE_PROGRAM_ZOO_ENABLE``: ``0`` (or
``false``, ``no``, empty) turns the warm-up off, any other value on;
unset, it is on where CUDA is available and off on the CPU.
"""

import os
import threading
import time
from typing import Any, Dict, List

import numpy as np

WARMUP_PAGES = 2  # the served requests' pages: one group of the default engine
WARMUP_PAGE_HW = (1024, 768)
WARMUP_WORDS = 64
WARMUP_SEED = 0

_LOCK = threading.Lock()
_REPORT: Dict[str, Any] = {"seconds": 0.0, "launches": {}, "parts": []}


def warmup_enabled() -> bool:
    """``MARIE_PROGRAM_ZOO_ENABLE`` when set, else whether CUDA is here."""
    env = os.environ.get("MARIE_PROGRAM_ZOO_ENABLE")
    if env is not None:
        return env.strip().lower() not in ("", "0", "false", "no")
    import torch

    return torch.cuda.is_available()


def warmup_pages(n: int = WARMUP_PAGES, hw=WARMUP_PAGE_HW, seed: int = WARMUP_SEED
                 ) -> List[np.ndarray]:
    """``n`` white RGB pages with lines of dark word-like bars."""
    rng = np.random.default_rng(seed)
    h, w = hw
    pages = []
    for _ in range(n):
        page = np.full((h, w), 255, np.uint8)
        for y in range(h // 16, h - h // 16, max(h // 24, 12)):
            x = w // 16
            while x < w - w // 8:
                ww = int(rng.integers(w // 40, w // 10))
                page[y:y + max(h // 80, 6), x:x + ww] = int(rng.integers(0, 60))
                x += ww + int(rng.integers(w // 80, w // 30))
        pages.append(np.stack([page] * 3, -1))
    return pages


def warmup_words(n: int = WARMUP_WORDS, seed: int = WARMUP_SEED):
    """(words, xywh boxes) of a drawn page: ``n`` words in lines."""
    rng = np.random.default_rng(seed)
    words, boxes = [], []
    for i in range(n):
        words.append("".join(chr(c) for c in rng.integers(97, 123, int(rng.integers(2, 9)))))
        boxes.append([40 + (i % 8) * 90, 40 + (i // 8) * 30, int(rng.integers(30, 80)), 18])
    return words, boxes


def _delta(before: Dict[str, Dict[str, int]], after: Dict[str, Dict[str, int]]):
    out: Dict[str, Dict[str, int]] = {}
    for kernel, paths in after.items():
        for path, n in paths.items():
            d = n - before.get(kernel, {}).get(path, 0)
            if d:
                out.setdefault(kernel, {})[path] = d
    return out


def _ocr_engine(executor):
    pipeline = getattr(executor, "pipeline", None)
    engine = getattr(pipeline, "ocr_engine", None) if pipeline is not None else None
    return engine if engine is not None else getattr(executor, "ocr_engine", None)


def _warm_engine(engine) -> None:
    engine.extract(warmup_pages())
    _synchronize()


def _warm_ner(executor) -> None:
    from marie_tpu_torch.components.base import PageInput
    from marie_tpu_torch.executor.ner_executor import reading_order_boxes

    words, boxes = warmup_words()
    if getattr(executor, "text_layout", None) is not None:
        order = executor.text_layout.order(*reading_order_boxes(boxes, None))
        words, boxes = [words[j] for j in order], [boxes[j] for j in order]
    executor.indexer.index([PageInput(words, boxes, None)])
    _synchronize()


def _synchronize() -> None:
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def prewarm(executor) -> Dict[str, Any]:
    """Run ``executor``'s programs once (see the module's notes); returns
    ``{"seconds", "launches", "parts"}`` of this warm-up.  Raises what the
    programs raise."""
    from marie_tpu_torch.ops.kernels._build import launch_counts, set_launch_counts

    parts: List[str] = []
    before = launch_counts()
    t0 = time.perf_counter()
    engine = _ocr_engine(executor)
    if engine is not None:
        _warm_engine(engine)
        parts.append("ocr_engine")
    if getattr(executor, "indexer", None) is not None:
        _warm_ner(executor)
        parts.append("ner")
    seconds = time.perf_counter() - t0
    launches = _delta(before, launch_counts())
    set_launch_counts(before)  # the requests' counts start where they were
    with _LOCK:
        _REPORT["seconds"] += seconds
        _REPORT["parts"] += parts
        for kernel, paths in launches.items():
            for path, n in paths.items():
                k = _REPORT["launches"].setdefault(kernel, {})
                k[path] = k.get(path, 0) + n
    return {"seconds": seconds, "launches": launches, "parts": parts}


def warmup_report() -> Dict[str, Any]:
    """The warm-ups of this process: seconds, launches by kernel and path,
    and the parts run."""
    with _LOCK:
        return {"seconds": _REPORT["seconds"],
                "launches": {k: dict(v) for k, v in _REPORT["launches"].items()},
                "parts": list(_REPORT["parts"])}
