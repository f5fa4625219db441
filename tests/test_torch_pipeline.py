"""The port's classification pipeline (``marie_tpu_torch/pipe/``) and its
host helpers against the JAX package's, on the CPU.

Mirrors ``tests/unit/test_pipeline.py::test_classification_pipeline``
and ``tests/unit/test_pipe_assets.py`` (naming, storage copies through an
in-memory ``s3://`` handler, store and restore, the OCR cache), and holds
the port to JAX on the same numpy inputs: the asset key
(``hash_frames_fast``) equal, an OCR cache written by either package read
by the other, and ``ClassificationPipeline`` with tiny seeded heads
(engine included) and with the trained ``-synth`` heads of
``model_zoo/`` (restored by orbax on the JAX side and bridged) equal to
JAX: labels, splits and documents equal, scores within 1e-5 (float32
summed in another order; measured ~1e-7).
"""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from marie_tpu.components.document_classifier import (
    LayoutDocumentClassifier as JaxClassifier,
)
from marie_tpu.components.document_splitter import LayoutDocumentSplitter as JaxSplitter
from marie_tpu.models import configs as jcfg
from marie_tpu.ocr.mock_ocr_engine import MockOcrEngine as JaxMockOcrEngine
from marie_tpu.pipe import ClassificationPipeline as JaxPipeline
from marie_tpu.utils.image_utils import hash_frames_fast as jax_hash_frames_fast
from marie_tpu_torch.components.document_classifier import LayoutDocumentClassifier
from marie_tpu_torch.components.document_splitter import LayoutDocumentSplitter
from marie_tpu_torch.models import configs as tcfg
from marie_tpu_torch.ocr.mock_ocr_engine import MockOcrEngine
from marie_tpu_torch.pipe import ClassificationPipeline
from marie_tpu_torch.pipe.assets import (
    filename_supplier_page,
    get_file_count,
    restore_assets,
    s3_asset_path,
    split_filename,
    store_assets,
)
from marie_tpu_torch.pipe.voting import majority_vote
from marie_tpu_torch.registry.convert import init_flax_layout
from marie_tpu_torch.registry.zoo import ZOO_DIR
from marie_tpu_torch.storage.manager import PathHandler, StorageManager
from marie_tpu_torch.utils.image_utils import hash_frames_fast

ATOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LABELS = ("invoice", "receipt", "letter")


class MemoryS3Handler(PathHandler):
    """In-memory s3:// handler (test double for an S3 client)."""

    def __init__(self, reachable=True):
        self.blobs = {}
        self.reachable = reachable

    def get_supported_prefixes(self):
        return ["s3://"]

    def ping(self):
        return self.reachable

    def exists(self, path):
        return path in self.blobs or any(
            k.startswith(path.rstrip("/") + "/") for k in self.blobs)

    def read_bytes(self, path):
        return self.blobs[path]

    def write_bytes(self, path, data):
        self.blobs[path] = data

    def list(self, path):
        base = path.rstrip("/")
        return sorted(k for k in self.blobs if k == base or k.startswith(base + "/"))


@pytest.fixture
def mem_s3():
    saved = dict(StorageManager._handlers)
    handler = MemoryS3Handler()
    StorageManager.register_handler(handler)
    yield handler
    StorageManager._handlers = saved


@pytest.fixture
def no_s3():
    saved = dict(StorageManager._handlers)
    StorageManager._handlers = {k: v for k, v in saved.items() if not k.startswith("s3")}
    yield
    StorageManager._handlers = saved


def _frames(n=2, h=64, w=96, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8) for _ in range(n)]


class CountingOcr(MockOcrEngine):
    def __init__(self):
        super().__init__()
        self.calls = 0

    def extract(self, *a, **kw):
        self.calls += 1
        return super().extract(*a, **kw)


# --- the asset key and naming ----------------------------------------------

@pytest.mark.parametrize("shapes,dtype", [
    ([(1024, 768)], np.uint8), ([(64, 96, 3), (130, 40, 3)], np.uint8),
    ([(5, 7)], np.uint8), ([(300, 200)], np.float32), ([], np.uint8),
])
def test_hash_frames_fast_matches_jax(shapes, dtype):
    rng = np.random.default_rng(len(shapes))
    frames = [(rng.random(s) * 255).astype(dtype) for s in shapes]
    assert hash_frames_fast(frames) == jax_hash_frames_fast(frames)
    if frames:
        frames[0] = frames[0].copy()
        frames[0].flat[0] += 1
        assert hash_frames_fast(frames) == jax_hash_frames_fast(frames)


def test_split_filename():
    assert split_filename("a/b/sample.tif") == ("sample.tif", "sample", "tif")
    assert split_filename("noext") == ("noext", "noext", "")
    assert split_filename("two.dots.png") == ("two.dots.png", "two.dots", "png")
    assert split_filename("dir/") == ("doc", "doc", "")
    assert filename_supplier_page("sample.tif", "sample", "", 3) == "sample_00003.tif"


def test_s3_asset_path_shapes(monkeypatch):
    monkeypatch.delenv("MARIE_S3_BUCKET", raising=False)
    assert s3_asset_path("sample.tif", "ocr") == "s3://marie/ocr/sample"
    assert s3_asset_path("SAMple.tif", "OCR") == "s3://marie/ocr/sample"
    assert s3_asset_path("SAMple.tif", "ocr", include_prefix=True) == (
        "s3://marie/ocr/sample/SAMple")
    assert s3_asset_path("SAMple.tif", "ocr", include_filename=True) == (
        "s3://marie/ocr/sample/SAMple.tif")
    # path traversal is neutralised
    assert ".." not in s3_asset_path("../../etc/passwd.tif", "a/../b")
    monkeypatch.setenv("MARIE_S3_BUCKET", "custom")
    assert s3_asset_path("x.tif", "t").startswith("s3://custom/")


# --- StorageManager dir copies ----------------------------------------------

def test_copy_dir_and_copy_remote_roundtrip(tmp_path, mem_s3):
    src = tmp_path / "src"
    (src / "clean").mkdir(parents=True)
    (src / "results").mkdir()
    (src / "clean" / "p0.png").write_bytes(b"png0")
    (src / "results" / "ocr.json").write_bytes(b"{}")
    (src / "top.txt").write_bytes(b"t")

    stored = StorageManager.copy_dir(str(src), "s3://marie/t/doc")
    assert sorted(os.path.basename(p) for p in stored) == ["ocr.json", "p0.png", "top.txt"]
    assert mem_s3.blobs["s3://marie/t/doc/clean/p0.png"] == b"png0"

    dst = tmp_path / "dst"
    restored = StorageManager.copy_remote("s3://marie/t/doc", str(dst))
    assert (dst / "clean" / "p0.png").read_bytes() == b"png0"
    assert len(restored) == 3

    # a wildcard narrows the restore to one subtree
    dst2 = tmp_path / "dst2"
    restored = StorageManager.copy_remote("s3://marie/t/doc", str(dst2),
                                          match_wildcard="clean/*")
    assert [os.path.basename(p) for p in restored] == ["p0.png"]
    assert not (dst2 / "results").exists()

    # overwrite=False keeps existing local bytes
    (dst / "clean" / "p0.png").write_bytes(b"local-edit")
    StorageManager.copy_remote("s3://marie/t/doc", str(dst), overwrite=False)
    assert (dst / "clean" / "p0.png").read_bytes() == b"local-edit"
    StorageManager.copy_remote("s3://marie/t/doc", str(dst), overwrite=True)
    assert (dst / "clean" / "p0.png").read_bytes() == b"png0"
    assert get_file_count(str(dst / "clean")) == 1 and get_file_count(str(tmp_path / "no")) == 0


def test_copy_dir_wildcard(tmp_path, mem_s3):
    src = tmp_path / "src"
    src.mkdir()
    (src / "a.json").write_bytes(b"{}")
    (src / "b.tif").write_bytes(b"x")
    stored = StorageManager.copy_dir(str(src), "s3://marie/t/doc", match_wildcard="*.json")
    assert [os.path.basename(p) for p in stored] == ["a.json"]


def test_ensure_connection(no_s3):
    assert StorageManager.ensure_connection("s3://", silence_exceptions=True) is False


def test_ensure_connection_unreachable():
    saved = dict(StorageManager._handlers)
    try:
        StorageManager.register_handler(MemoryS3Handler(reachable=False))
        assert StorageManager.ensure_connection("s3://", silence_exceptions=True) is False
        with pytest.raises(Exception):
            StorageManager.ensure_connection("s3://", silence_exceptions=False)
    finally:
        StorageManager._handlers = saved


def test_local_paths_go_to_the_native_handler(tmp_path):
    path = str(tmp_path / "a" / "b.bin")
    StorageManager.write(path, b"xyz")
    assert StorageManager.exists(path) and StorageManager.read(path) == b"xyz"
    assert StorageManager.list(str(tmp_path)) == [path]


# --- store/restore ----------------------------------------------------------

def test_store_and_restore_assets(tmp_path, mem_s3):
    local = tmp_path / "run1"
    (local / "clean").mkdir(parents=True)
    (local / "clean" / "c0.png").write_bytes(b"c0")
    (local / "burst").mkdir()
    (local / "burst" / "b0.tif").write_bytes(b"b0")
    stored = store_assets("doc.tif", "ocr", str(local))
    assert len(stored) == 2

    # a partial restore pulls clean/results/pdf but not burst
    fresh = tmp_path / "run2"
    fresh.mkdir()
    base = restore_assets("doc.tif", "ocr", str(fresh))
    assert base == "s3://marie/ocr/doc"
    assert (fresh / "clean" / "c0.png").read_bytes() == b"c0"
    assert not (fresh / "burst").exists()

    full = tmp_path / "run3"
    full.mkdir()
    restore_assets("doc.tif", "ocr", str(full), full_restore=True)
    assert (full / "burst" / "b0.tif").read_bytes() == b"b0"


def test_store_restore_without_storage(tmp_path, no_s3):
    # best-effort: no s3 handler registered -> no raise, empty results
    assert store_assets("d.tif", "t", str(tmp_path)) == []
    assert restore_assets("d.tif", "t", str(tmp_path)) is None


# --- the OCR cache ----------------------------------------------------------

def test_classification_pipeline_ocr_cache(tmp_path, no_s3):
    ocr = CountingOcr()
    pipe = ClassificationPipeline(ocr_engine=ocr, work_dir=str(tmp_path))
    frames = _frames(2, 128, 128)
    meta1 = pipe.execute("doc.tif", "ocr", frames)
    assert ocr.calls == 1
    meta2 = pipe.execute("doc.tif", "ocr", frames)
    assert ocr.calls == 1  # cache hit: OCR not re-run
    assert meta2["pages"] == meta1["pages"] and meta2["ocr"] == meta1["ocr"]
    # the cache file is real JSON on disk
    runs = os.listdir(tmp_path)
    with open(os.path.join(tmp_path, runs[0], "results", "ocr.json")) as fp:
        assert isinstance(json.load(fp), list)
    with pytest.raises(ValueError):
        ClassificationPipeline(work_dir=str(tmp_path)).execute("d", "t", _frames(1, 32, 32))


def test_ocr_cache_restored_from_storage(tmp_path, mem_s3):
    """A second host restores ``results/ocr.json`` from primary storage and
    runs no OCR."""
    frames = _frames(2, 96, 96, seed=3)
    first = CountingOcr()
    ClassificationPipeline(ocr_engine=first, work_dir=str(tmp_path / "hostA")).execute(
        "doc.tif", "ocr", frames)
    assert first.calls == 1 and any(k.endswith("results/ocr.json") for k in mem_s3.blobs)
    second = CountingOcr()
    meta = ClassificationPipeline(ocr_engine=second, work_dir=str(tmp_path / "hostB")).execute(
        "doc.tif", "ocr", frames)
    assert second.calls == 0 and len(meta["ocr"]) == 2


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_ocr_cache_is_shared_with_jax(tmp_path, no_s3, writer):
    """An OCR cache written by either package is read by the other: same
    asset directory, same JSON, no OCR run by the reader."""
    frames = _frames(3, 80, 120, seed=5)
    if writer == "jax":
        written = JaxPipeline(ocr_engine=JaxMockOcrEngine(), work_dir=str(tmp_path)).execute(
            "doc.tif", "ocr", frames)
        reader = CountingOcr()
        meta = ClassificationPipeline(ocr_engine=reader, work_dir=str(tmp_path)).execute(
            "doc.tif", "ocr", frames)
        assert reader.calls == 0
    else:
        written = ClassificationPipeline(ocr_engine=MockOcrEngine(),
                                         work_dir=str(tmp_path)).execute("doc.tif", "ocr", frames)

        class Refusing(JaxMockOcrEngine):
            def extract(self, *a, **kw):
                raise AssertionError("the JAX pipeline ran OCR despite the cache")

        meta = JaxPipeline(ocr_engine=Refusing(), work_dir=str(tmp_path)).execute(
            "doc.tif", "ocr", frames)
    assert os.listdir(tmp_path) == [hash_frames_fast(frames)]
    assert meta["ocr"] == json.loads(json.dumps(written["ocr"]))


# --- the pipeline against JAX -------------------------------------------------

def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def assert_close_tree(got, want, atol=ATOL, path="$"):
    """Equal structure and values; floats within ``atol``."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            assert_close_tree(got[k], want[k], atol, f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close_tree(g, w, atol, f"{path}[{i}]")
    elif isinstance(want, float):
        assert isinstance(got, float) and abs(got - want) <= atol, (path, got, want)
    else:
        assert got == want, (path, got, want)


def test_classification_pipeline(tmp_path):
    """test_pipeline.py's case on the port: three white pages, the tiny
    classifier and splitter, the mock engine."""
    classifier = LayoutDocumentClassifier(LABELS, tcfg.LayoutLMConfig.tiny(num_labels=3),
                                          device="cpu")
    splitter = LayoutDocumentSplitter(config=tcfg.LayoutLMConfig.tiny(num_labels=2),
                                      device="cpu")
    pipe = ClassificationPipeline(ocr_engine=MockOcrEngine(), classifiers=[classifier],
                                  splitter=splitter, work_dir=str(tmp_path))
    frames = [np.full((300, 400, 3), 255, np.uint8) for _ in range(3)]
    meta = pipe.execute("d", "t", frames)
    assert len(meta["page_classifier"]) == 3
    assert len(meta["splitter"]) == 3
    assert meta["splitter"][0]["is_boundary"] is True
    assert sum(len(d) for d in meta["documents"]) == 3


def test_majority_vote_matches_jax():
    from marie_tpu.pipe.voting import majority_vote as jax_vote

    cases = [[], [{"label": "a", "score": 0.4}],
             [{"label": "a", "score": 0.4}, {"label": "b", "score": 0.9}],
             [{"label": "a", "score": 0.4}, {"label": "b", "score": 0.9},
              {"label": "a", "score": 0.6}]]
    for c in cases:
        assert majority_vote(c) == jax_vote(c)


@pytest.fixture(scope="module")
def tiny_engines():
    """(port engine, JAX engine): tiny seeded CRAFT (ink boxes) and TrOCR,
    float32, on the CPU."""
    from marie_tpu.boxes.craft_box_processor import BoxProcessorCraft as JaxBoxProcessorCraft
    from marie_tpu.document.trocr_ocr_processor import TrOcrProcessor as JaxTrOcrProcessor
    from marie_tpu.ocr.ocr_engine import PipelineOcrEngine as JaxEngine
    from marie_tpu_torch.boxes.craft_box_processor import BoxProcessorCraft
    from marie_tpu_torch.document.trocr_ocr_processor import TrOcrProcessor
    from marie_tpu_torch.ocr.ocr_engine import PipelineOcrEngine

    craft_tree = init_flax_layout(tcfg.CraftConfig.tiny(), 7)
    trocr_tree = init_flax_layout(tcfg.TrOCRConfig.tiny(), 8)
    port = PipelineOcrEngine(
        BoxProcessorCraft(tcfg.CraftConfig.tiny(), craft_tree, box_source="ink",
                          max_components=64, device="cpu"),
        TrOcrProcessor(tcfg.TrOCRConfig.tiny(), trocr_tree, batch_sizes=(8, 32), device="cpu"))
    jax_engine = JaxEngine(
        JaxBoxProcessorCraft(config=jcfg.CraftConfig.tiny(), box_source="ink",
                             max_components=64, variables=_jnp(craft_tree)),
        JaxTrOcrProcessor(config=jcfg.TrOCRConfig.tiny(), batch_sizes=(8, 32),
                          params=_jnp(trocr_tree)))
    return port, jax_engine


def _ink_pages(n, seed, h=256, w=384):
    """White pages with a few word-shaped ink blocks."""
    rng = np.random.default_rng(seed)
    pages = []
    for _ in range(n):
        page = np.full((h, w), 255, np.uint8)
        for _ in range(6):
            x, y = int(rng.integers(8, w - 100)), int(rng.integers(8, h - 30))
            ww, th = int(rng.integers(30, 90)), int(rng.integers(12, 20))
            for gx in range(x, x + ww, int(rng.integers(5, 8))):
                page[y + int(rng.integers(0, 3)):y + th, gx:gx + 3] = int(rng.integers(0, 90))
        pages.append(page)
    return pages


def test_pipeline_with_engine_and_tiny_heads_matches_jax(tmp_path, no_s3, tiny_engines):
    """The whole pipeline, OCR included, on the same pages and weights:
    the port's metadata equals JAX's (OCR result dicts, confidences within
    1e-3 as the engine tests hold them; labels, splits and documents
    equal; scores within 1e-5); a second ``execute`` reads the cache,
    runs no OCR and gives the same metadata."""
    port_engine, jax_engine = tiny_engines
    cls_tree = init_flax_layout(tcfg.LayoutLMConfig.tiny(3), 5, "sequence")
    split_tree = init_flax_layout(tcfg.LayoutLMConfig.tiny(2), 6, "sequence")
    frames = _ink_pages(3, 11)

    class Counting:
        def __init__(self, engine):
            self.engine, self.calls = engine, 0

        def extract(self, *a, **kw):
            self.calls += 1
            return self.engine.extract(*a, **kw)

    engine = Counting(port_engine)
    pipe = ClassificationPipeline(
        ocr_engine=engine,
        classifiers=[LayoutDocumentClassifier(LABELS, tcfg.LayoutLMConfig.tiny(3), cls_tree,
                                              device="cpu")],
        splitter=LayoutDocumentSplitter(config=tcfg.LayoutLMConfig.tiny(2), params=split_tree,
                                        device="cpu"),
        work_dir=str(tmp_path / "port"))
    got = pipe.execute("doc.tif", "ocr", frames)
    want = JaxPipeline(
        ocr_engine=jax_engine,
        classifiers=[JaxClassifier(LABELS, jcfg.LayoutLMConfig.tiny(3), _jnp(cls_tree))],
        splitter=JaxSplitter(config=jcfg.LayoutLMConfig.tiny(2), params=_jnp(split_tree)),
        work_dir=str(tmp_path / "jax")).execute("doc.tif", "ocr", frames)
    assert sum(len(p["words"]) for p in got["ocr"]) > 0
    assert_close_tree(got["ocr"], want["ocr"], atol=1e-3)
    for key in ("page_classifier", "splitter", "documents"):
        assert_close_tree(got[key], want[key])
    assert {k: v for k, v in got.items() if k != "ocr"}.keys() == {
        k for k in want if k != "ocr"}

    again = pipe.execute("doc.tif", "ocr", frames)
    assert engine.calls == 1
    assert again["ocr"] == json.loads(json.dumps(got["ocr"]))
    for key in ("page_classifier", "splitter", "documents"):
        assert again[key] == got[key]


def _shipped(pages_idx):
    with np.load(os.path.join(ZOO_DIR, "pages.npz")) as data:
        frames = [data["pages"][i] for i in pages_idx]
    with open(os.path.join(ZOO_DIR, "golden.json")) as f:
        golden = json.load(f)["pages"]
    return frames, [golden[i] for i in pages_idx]


def test_trained_synth_heads_on_shipped_pages_match_jax(tmp_path):
    """Two shipped pages with the golden's OCR results through the trained
    ``layout-classifier-synth`` and ``layout-splitter-synth`` (orbax on
    the JAX side, the same trees bridged into the port): labels, split and
    documents equal, scores within 1e-5."""
    from marie_tpu.registry.checkpoints import load_params as load_orbax
    from marie_tpu_torch.components.document_classifier.layoutlm_classifier import (
        SYNTH_CLASS_LABELS,
    )

    frames, ocr = _shipped([0, 5])
    jax_cls = JaxClassifier.from_zoo()
    jax_split = JaxSplitter()
    assert jax_cls is not None and jax_split.classifier.config == jcfg.LayoutLMConfig.synth(2)

    def tree(name):
        return jax.device_get(load_orbax(os.path.join(REPO, "model_zoo", name)))

    cls = LayoutDocumentClassifier(SYNTH_CLASS_LABELS, tcfg.LayoutLMConfig.synth(3),
                                   tree("layout-classifier-synth"), device="cpu")
    splitter = LayoutDocumentSplitter(config=tcfg.LayoutLMConfig.synth(2),
                                      params=tree("layout-splitter-synth"), device="cpu")
    got = ClassificationPipeline(classifiers=[cls], splitter=splitter,
                                 work_dir=str(tmp_path)).execute(
        "shipped", "classify", frames, ocr_results=ocr)
    want = JaxPipeline(classifiers=[jax_cls], splitter=jax_split,
                       work_dir=str(tmp_path)).execute("shipped", "classify", frames,
                                                       ocr_results=ocr)
    for key in ("page_classifier", "splitter", "documents"):
        assert_close_tree(got[key], want[key])
    assert os.listdir(tmp_path) == [hash_frames_fast(frames)]  # ocr_results: nothing cached
