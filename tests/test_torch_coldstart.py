"""The cold start (the counterparts of ``utils/jax_cache.py`` and
``utils/program_zoo.py``) and fault 5, on the CPU.

* ``prewarm`` runs an executor's programs before readiness: in a spawned
  worker pod with ``MARIE_PROGRAM_ZOO_ENABLE=1`` (a tiny seeded engine on
  the CPU) the warm-up ran before the first request, and the first answer
  equals an unwarmed pod's; a warm-up that raises makes the pod's start
  fail (``RuntimeFailToStart``); the warm-up's kernel launches are kept
  apart from the requests'.
* ``enable_persistent_cache`` builds only the kernel libraries that are
  missing, into ``_build.BUILD_DIR``; ``run_server`` refuses to serve on
  the card where CUDA is absent rather than fall back.
* Fault 5: where the reading-order model fails to load, the port's
  ``NerExtractionExecutor`` serves unordered as the JAX one does, with
  equal ``/ner/extract`` answers.

The pods' executors are defined here at module level and import nothing
of JAX."""

import dataclasses

import numpy as np
import pytest

from marie_tpu_torch.serve.executors import BaseExecutor
from marie_tpu_torch.serve.executors.decorators import requests, safely_encoded

SEED = 11


def tiny_engine():
    """A tiny seeded CRAFT (ink boxes) + TrOCR engine on the CPU."""
    from marie_tpu_torch.boxes.craft_box_processor import BoxProcessorCraft
    from marie_tpu_torch.document.trocr_ocr_processor import TrOcrProcessor
    from marie_tpu_torch.models import configs as tcfg
    from marie_tpu_torch.ocr.ocr_engine import PipelineOcrEngine
    from marie_tpu_torch.registry.convert import init_flax_layout

    return PipelineOcrEngine(
        BoxProcessorCraft(tcfg.CraftConfig.tiny(), init_flax_layout(tcfg.CraftConfig.tiny(), 7),
                          box_source="ink", max_components=64, device="cpu"),
        TrOcrProcessor(tcfg.TrOCRConfig.tiny(), init_flax_layout(tcfg.TrOCRConfig.tiny(), 8),
                       batch_sizes=(8, 32), device="cpu"))


def ink_pages(n=2, seed=SEED, h=192, w=256):
    rng = np.random.default_rng(seed)
    pages = []
    for _ in range(n):
        page = np.full((h, w), 255, np.uint8)
        for _ in range(5):
            x, y = int(rng.integers(8, w - 90)), int(rng.integers(8, h - 30))
            page[y:y + 14, x:x + int(rng.integers(30, 80))] = int(rng.integers(0, 90))
        pages.append(page)
    return pages


class TinyOcr(BaseExecutor):
    """An OCR executor on a tiny engine; its answer says whether a warm-up
    had run in its process before the request."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.ocr_engine = tiny_engine()

    @requests(on="/ocr")
    @safely_encoded
    def ocr(self, docs, **kwargs):
        from marie_tpu_torch.utils.program_zoo import warmup_report

        results = self.ocr_engine.extract([np.asarray(d.tensor) for d in docs])
        return {"results": results, "warmed": warmup_report()["parts"]}


class _BrokenEngine:
    def extract(self, frames, **kwargs):
        raise RuntimeError("warm-up failed")


class FailingWarmup(BaseExecutor):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.ocr_engine = _BrokenEngine()

    @requests(on="/x")
    def x(self, docs, **kwargs):
        return docs


def test_warmup_switch(monkeypatch):
    import torch

    from marie_tpu_torch.utils.program_zoo import warmup_enabled

    monkeypatch.delenv("MARIE_PROGRAM_ZOO_ENABLE", raising=False)
    assert warmup_enabled() == torch.cuda.is_available()
    for value, want in (("1", True), ("yes", True), ("0", False), ("false", False),
                        ("", False), ("no", False)):
        monkeypatch.setenv("MARIE_PROGRAM_ZOO_ENABLE", value)
        assert warmup_enabled() is want


def test_prewarm_keeps_its_launches_apart():
    """A warm-up's launches leave the requests' counts as they were and
    land in the warm-up's report."""
    from marie_tpu_torch.ops.kernels import _build
    from marie_tpu_torch.utils import program_zoo

    def fake_kernel():
        pass

    fake_kernel.launches, fake_kernel.launches_by_path = 0, {}
    with _build.launch_path("fused"):
        _build.count_launch(fake_kernel)  # a request's launch before the warm-up

    class CountingEngine:
        def extract(self, frames, **kwargs):
            assert len(frames) == program_zoo.WARMUP_PAGES
            with _build.launch_path("fused"):
                for _ in range(3):
                    _build.count_launch(fake_kernel)
            with _build.launch_path("heads"):
                _build.count_launch(fake_kernel)

    executor = BaseExecutor()
    executor.ocr_engine = CountingEngine()
    before = program_zoo.warmup_report()
    got = program_zoo.prewarm(executor)
    assert got["parts"] == ["ocr_engine"]
    assert got["launches"] == {"fake_kernel": {"fused": 3, "heads": 1}}
    assert _build.launch_counts()["fake_kernel"] == {"fused": 1}
    assert fake_kernel.launches == 1
    after = program_zoo.warmup_report()
    assert after["launches"]["fake_kernel"]["fused"] == \
        before["launches"].get("fake_kernel", {}).get("fused", 0) + 3
    from marie_tpu_torch.metrics.prometheus import render_warmup

    assert 'marie_warmup_launches_total{kernel="fake_kernel",path="heads"}' in \
        render_warmup(after)
    with _build._COUNT_LOCK:
        _build._COUNTED.pop("fake_kernel", None)


def test_prewarm_leaves_the_first_answer_unchanged():
    """The engine warmed on the served shapes answers as an unwarmed one."""
    from marie_tpu_torch.utils import program_zoo

    warm, cold = tiny_engine(), tiny_engine()
    ex = BaseExecutor()
    ex.ocr_engine = warm
    got = program_zoo.prewarm(ex)
    assert got["parts"] == ["ocr_engine"] and got["seconds"] > 0
    pages = ink_pages()
    assert warm.extract(pages) == cold.extract(pages)
    assert len(program_zoo.warmup_pages()) == program_zoo.WARMUP_PAGES
    assert program_zoo.warmup_pages()[0].shape == (*program_zoo.WARMUP_PAGE_HW, 3)


def test_warmed_pod_answers_as_an_unwarmed_one_and_a_failed_warmup_fails_the_start(
        monkeypatch):
    import http.client
    import json

    from marie_tpu_torch.clients import HTTPClient
    from marie_tpu_torch.excepts import RuntimeFailToStart
    from marie_tpu_torch.orchestrate.pods import Pod
    from marie_tpu_torch.types import Document

    pods = {}
    for value in ("1", "0"):  # the child takes the switch from the environment
        monkeypatch.setenv("MARIE_PROGRAM_ZOO_ENABLE", value)
        pods[value] = Pod("worker", uses=TinyOcr, protocol="http", name=f"ocr{value}").launch()
    monkeypatch.setenv("MARIE_PROGRAM_ZOO_ENABLE", "1")
    failing = Pod("worker", uses=FailingWarmup, protocol="http", name="failing").launch()
    try:
        answers, metrics = {}, {}
        for value, pod in pods.items():
            pod.wait_ready()
            client = HTTPClient(port=pod.port)
            body = client.post("/ocr", [Document(tensor=p) for p in ink_pages()],
                               return_responses=True)
            answers[value] = body["parameters"]["__results__"][f"ocr{value}"]
            conn = http.client.HTTPConnection("127.0.0.1", pod.port, timeout=30)
            conn.request("GET", "/metrics")
            metrics[value] = conn.getresponse().read().decode()
            conn.close()
            client.close()
        with pytest.raises(RuntimeFailToStart):
            failing.wait_ready(timeout=60)
    finally:
        for pod in (*pods.values(), failing):
            pod.close()
    assert answers["1"]["warmed"] == ["ocr_engine"] and answers["0"]["warmed"] == []
    assert json.dumps(answers["1"]["results"]) == json.dumps(answers["0"]["results"])
    assert "marie_warmup_seconds" in metrics["1"] and "marie_warmup_seconds" not in metrics["0"]
    assert failing.exitcode not in (0, None)


def test_kernel_cache_builds_only_what_is_missing(monkeypatch, tmp_path):
    from marie_tpu_torch.ops.kernels import _build
    from marie_tpu_torch.utils import kernel_cache

    assert kernel_cache.default_cache_dir() == _build.BUILD_DIR
    present = {"crop_resize"}

    def lib_path(name):
        if name in present:
            path = tmp_path / f"lib{name}.so"
            path.write_bytes(b"")
            return path
        return tmp_path / f"missing-{name}.so"

    monkeypatch.setattr(_build, "_lib_path", lib_path)
    asked = []
    monkeypatch.setattr(_build, "build_all", lambda names: asked.append(list(names)) or
                        {n: 1.0 for n in names})
    # the RAFT core (host C++) builds beside the kernels when it is missing
    from marie_tpu_torch.serve import consensus

    monkeypatch.setattr(consensus, "build_library",
                        lambda: None if "raft" in present else asked.append(["raft"]) or 2.0)
    got = kernel_cache.enable_persistent_cache()
    assert asked == [[n for n in _build.sources() if n not in present], ["raft"]]
    assert set(got) == set(_build.sources()) - present | {"raft"} and got["raft"] == 2.0
    present.update(_build.sources())
    present.add("raft")
    asked.clear()
    assert kernel_cache.enable_persistent_cache() == {} and asked == []


def test_run_server_needs_the_card_unless_asked_for_the_cpu():
    import inspect

    import torch

    from marie_tpu_torch.server import run_server

    assert inspect.signature(run_server).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            run_server(uses=None)


def test_ner_serves_unordered_where_reading_order_fails_to_load(monkeypatch):
    """Fault 5: the reading-order load raises on both sides; each executor
    keeps ``text_layout`` None and the answers are equal."""
    import jax
    import jax.numpy as jnp

    import marie_tpu.document.layoutreader as jlayout
    import marie_tpu_torch.document.layoutreader as tlayout
    from marie_tpu.components.document_indexer import LayoutDocumentIndexer as JIndexer
    from marie_tpu.executor import NerExtractionExecutor as JExecutor
    from marie_tpu.models import configs as jcfg
    from marie_tpu.types.docs import Document as JDocument
    from marie_tpu.types.docs import DocumentArray as JDocumentArray
    from marie_tpu_torch.components.document_indexer import LayoutDocumentIndexer
    from marie_tpu_torch.executor import NerExtractionExecutor
    from marie_tpu_torch.models import configs as tcfg
    from marie_tpu_torch.registry.convert import init_flax_layout
    from marie_tpu_torch.types.docs import Document, DocumentArray
    from tests.test_torch_layoutlm import assert_close_tree

    def broken(*args, **kwargs):
        raise OSError("reading-order checkpoint unreadable")

    monkeypatch.setattr(jlayout, "load_text_layout", broken)
    monkeypatch.setattr(tlayout, "load_text_layout", broken)
    labels = ("O", "B-KEY", "I-KEY", "B-VALUE", "I-VALUE")
    jc = dataclasses.replace(jcfg.LayoutLMConfig.tiny(len(labels)), use_image=False,
                             max_seq_len=64)
    tc = dataclasses.replace(tcfg.LayoutLMConfig.tiny(len(labels)), use_image=False,
                             max_seq_len=64)
    tree = init_flax_layout(tc, 31, "token")
    rng = np.random.default_rng(SEED)
    words = [f"w{i}" for i in range(20)]
    boxes = [[int(x), int(y), 40, 12] for x, y in rng.integers(0, 600, (20, 2))]
    for reading_order in (True, None):
        port = NerExtractionExecutor(
            indexer=LayoutDocumentIndexer(labels, tc, tree, stride=32, device="cpu"),
            reading_order=reading_order, device="cpu")
        ref = JExecutor(indexer=JIndexer(labels, jc, jax.tree_util.tree_map(jnp.asarray, tree),
                                         stride=32), reading_order=reading_order)
        assert port.text_layout is None and ref.text_layout is None
        got = port.extract(DocumentArray([Document(id="n0", tags={"words": words,
                                                                  "boxes": boxes})]), {})
        want = ref.extract(JDocumentArray([JDocument(id="n0", tags={"words": words,
                                                                    "boxes": boxes})]), {})
        assert got["status"] == want["status"] == "succeeded"
        assert_close_tree(got["entities"], want["entities"], atol=1e-5)
