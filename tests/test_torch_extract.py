"""The port's extract pipeline (``marie_tpu_torch/pipe/extract_pipeline.py``),
its renderers and its default engine against the JAX package's, on the
CPU.

* Each renderer on the same OCR results (the golden's, on two shipped
  pages, in xywh and xyxy): ``results.txt``, the BLOBS and Adlib XML
  (``CreationDate`` blanked), and the PDF's objects and inflated content
  streams byte for byte; the embedded JPEG decodes within the limits of
  ``tests/test_torch_image_io.py`` (with this PIL it is byte-identical,
  and so is the whole PDF).
* ``ExtractPipeline`` with tiny seeded engines and heads on two small
  pages: OCR (confidences within 1e-3, as the engine tests hold them),
  ``page_classifier`` and ``page_indexer`` (scores within 1e-5), the
  asset listing, the renderers' files and ``results.json`` as JAX's.
* The tiny generator in the pipeline: ``clean/`` pages equal to JAX's in
  >= 99.8% of pixels and never 2 gray levels apart (``TINY_PIXELS_EQUAL``),
  ``results.tif`` equal to the cleaned frames; a
  rerun of the same asset directory bursts nothing and runs no
  generator, and reads the same clean pages back.
* The feature flags and regions of ``tests/unit/test_pipeline.py``.
"""

import io
import json
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from marie_tpu.components.document_classifier import (
    LayoutDocumentClassifier as JaxClassifier,
)
from marie_tpu.components.document_indexer import LayoutDocumentIndexer as JaxIndexer
from marie_tpu.models import configs as jcfg
from marie_tpu.overlay.overlay import OverlayProcessor as JaxOverlay
from marie_tpu.pipe import ExtractPipeline as JaxExtractPipeline
from marie_tpu.renderer import AdlibRenderer as JaxAdlib
from marie_tpu.renderer import BlobRenderer as JaxBlob
from marie_tpu.renderer import PdfRenderer as JaxPdf
from marie_tpu.renderer import TextRenderer as JaxText
from marie_tpu_torch.components.document_classifier import LayoutDocumentClassifier
from marie_tpu_torch.components.document_indexer import LayoutDocumentIndexer
from marie_tpu_torch.models import configs as tcfg
from marie_tpu_torch.ocr.mock_ocr_engine import MockOcrEngine
from marie_tpu_torch.overlay.overlay import OverlayProcessor
from marie_tpu_torch.pipe import ExtractPipeline
from marie_tpu_torch.pipe import assets as port_assets
from marie_tpu_torch.registry.convert import init_flax_layout
from marie_tpu_torch.registry.zoo import ZOO_DIR, open_zoo_json
from marie_tpu_torch.renderer import AdlibRenderer, BlobRenderer, PdfRenderer, TextRenderer
from marie_tpu_torch.renderer.pdf_renderer import read_pdf
from marie_tpu_torch.utils.image_io import read_png, read_tiff

OCR_ATOL = 1e-3
SCORE_ATOL = 1e-5
#: the seeded tiny generator's clean pages against JAX's: its float32
#: outputs differ by up to ~4e-6, and ``clip((fake + 1) * 127.5)``
#: truncates ~0.1% of them to the other gray level (measured: masks
#: equal, pixels 99.84-99.90% equal, never 2 apart)
TINY_PIXELS_EQUAL = 0.998
LABELS = ("invoice", "receipt", "letter")
NER_LABELS = ("O", "B-KEY", "I-KEY")


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture
def no_s3():
    from marie_tpu_torch.storage.manager import StorageManager

    saved = dict(StorageManager._handlers)
    StorageManager._handlers = {k: v for k, v in saved.items() if not k.startswith("s3")}
    yield
    StorageManager._handlers = saved


def _shipped(idx):
    with np.load(os.path.join(ZOO_DIR, "pages.npz")) as data:
        frames = [data["pages"][i] for i in idx]
    with open_zoo_json("golden") as f:
        golden = json.load(f)["pages"]
    return frames, [golden[i] for i in idx]


def _xyxy(results):
    out = json.loads(json.dumps(results))
    for r in out:
        r["meta"]["format"] = "xyxy"
        for w in r["words"]:
            x, y, bw, bh = w["box"]
            w["box"] = [x, y, x + bw, y + bh]
    return out


def _pdf_objects(data):
    """{object number: body} of a PDF, image streams cut out."""
    objs = {}
    for m in re.finditer(rb"(\d+) 0 obj\n(.*?)\nendobj\n", data, re.S):
        body = m.group(2)
        if b"/DCTDecode" in body:
            body = re.sub(rb"/Length \d+ >>\nstream\n.*\nendstream", b"<image>", body, flags=re.S)
        elif b"/FlateDecode" in body:
            body = b"<content>"
        objs[int(m.group(1))] = body
    return objs


@pytest.mark.parametrize("fmt", ["xywh", "xyxy"])
def test_renderers_match_jax(tmp_path, fmt):
    import hashlib

    from PIL import Image

    frames, ocr = _shipped([0, 3])
    frames[1] = np.stack([frames[1]] * 3, axis=-1)  # an RGB page too
    if fmt == "xyxy":
        ocr = _xyxy(ocr)
    pairs = [(TextRenderer({"preserve_interword_spaces": True}),
              JaxText({"preserve_interword_spaces": True}), "results.txt"),
             (BlobRenderer(), JaxBlob(), "blobs"), (AdlibRenderer(), JaxAdlib(), "adlib"),
             (PdfRenderer(), JaxPdf(), "results.pdf")]
    for port, ref, name in pairs:
        port.render(frames, json.loads(json.dumps(ocr)), str(tmp_path / "port" / name)
                    if name in ("blobs", "adlib") else _out(tmp_path / "port", name))
        ref.render(frames, json.loads(json.dumps(ocr)), str(tmp_path / "jax" / name)
                   if name in ("blobs", "adlib") else _out(tmp_path / "jax", name))

    def read(side, rel):
        return (tmp_path / side / rel).read_bytes()

    assert read("port", "results.txt") == read("jax", "results.txt")
    for rel in sorted(os.listdir(tmp_path / "jax" / "blobs")):
        assert read("port", f"blobs/{rel}") == read("jax", f"blobs/{rel}")
    blank = re.compile(rb'(FIELD="CreationDate" VALUE=")[^"]*"')
    assert sorted(os.listdir(tmp_path / "port" / "adlib")) == sorted(
        os.listdir(tmp_path / "jax" / "adlib"))
    for rel in sorted(os.listdir(tmp_path / "jax" / "adlib")):
        assert blank.sub(rb'\1"', read("port", f"adlib/{rel}")) == blank.sub(
            rb'\1"', read("jax", f"adlib/{rel}"))
    ours, theirs = read("port", "results.pdf"), read("jax", "results.pdf")
    assert _pdf_objects(ours) == _pdf_objects(theirs)
    pages, ref_pages = read_pdf(ours), read_pdf(theirs)
    assert len(pages) == len(ref_pages) == 2
    for page, ref_page, frame in zip(pages, ref_pages, frames):
        assert page["content"] == ref_page["content"]
        assert (page["width"], page["height"]) == (ref_page["width"], ref_page["height"])
        rgb = frame if frame.ndim == 3 else np.stack([frame] * 3, axis=-1)
        got = np.asarray(Image.open(io.BytesIO(page["jpeg"])).convert("RGB"))
        want = np.asarray(Image.open(io.BytesIO(ref_page["jpeg"])).convert("RGB"))

        def psnr(x):
            return 10 * np.log10(255.0 ** 2 / np.mean((x.astype(float) - rgb) ** 2))

        assert psnr(got) >= psnr(want) - 0.5
        assert abs(len(page["jpeg"]) - len(ref_page["jpeg"])) <= 0.15 * len(ref_page["jpeg"])
    # measured with this PIL: the JPEG, and so the whole file, is PIL's
    assert hashlib.sha256(ours).digest() == hashlib.sha256(theirs).digest()


def _out(root, name):
    root.mkdir(parents=True, exist_ok=True)
    return str(root / name)


# --- the pipeline against JAX ---------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    """Tiny seeded engines (ink CRAFT + TrOCR), heads and generator, float32,
    one set for each package on the same trees."""
    from marie_tpu.boxes.craft_box_processor import BoxProcessorCraft as JaxBoxProcessorCraft
    from marie_tpu.document.trocr_ocr_processor import TrOcrProcessor as JaxTrOcrProcessor
    from marie_tpu.ocr.ocr_engine import PipelineOcrEngine as JaxEngine
    from marie_tpu_torch.boxes.craft_box_processor import BoxProcessorCraft
    from marie_tpu_torch.document.trocr_ocr_processor import TrOcrProcessor
    from marie_tpu_torch.ocr.ocr_engine import PipelineOcrEngine

    craft = init_flax_layout(tcfg.CraftConfig.tiny(), 7)
    trocr = init_flax_layout(tcfg.TrOCRConfig.tiny(), 8)
    cls = init_flax_layout(tcfg.LayoutLMConfig.tiny(3), 5, "sequence")
    ner = init_flax_layout(tcfg.LayoutLMConfig.tiny(3), 9, "token")
    gen = init_flax_layout(tcfg.Pix2PixConfig.tiny(), 4)
    port = {
        "engine": PipelineOcrEngine(
            BoxProcessorCraft(tcfg.CraftConfig.tiny(), craft, box_source="ink",
                              max_components=64, device="cpu"),
            TrOcrProcessor(tcfg.TrOCRConfig.tiny(), trocr, batch_sizes=(8, 32), device="cpu")),
        "classifiers": [LayoutDocumentClassifier(LABELS, tcfg.LayoutLMConfig.tiny(3), cls,
                                                 device="cpu")],
        "indexers": [LayoutDocumentIndexer(NER_LABELS, tcfg.LayoutLMConfig.tiny(3), ner,
                                           window=16, stride=8, device="cpu")],
        "overlay": OverlayProcessor(config=tcfg.Pix2PixConfig.tiny(), variables=gen,
                                    compute_dtype="float32", device="cpu"),
    }
    ref = {
        "engine": JaxEngine(
            JaxBoxProcessorCraft(config=jcfg.CraftConfig.tiny(), box_source="ink",
                                 max_components=64, variables=_jnp(craft)),
            JaxTrOcrProcessor(config=jcfg.TrOCRConfig.tiny(), batch_sizes=(8, 32),
                              params=_jnp(trocr))),
        "classifiers": [JaxClassifier(LABELS, jcfg.LayoutLMConfig.tiny(3), _jnp(cls))],
        "indexers": [JaxIndexer(NER_LABELS, jcfg.LayoutLMConfig.tiny(3), _jnp(ner),
                                window=16, stride=8)],
        "overlay": JaxOverlay(config=jcfg.Pix2PixConfig.tiny(), variables=_jnp(gen),
                              compute_dtype=jnp.float32),
    }
    return port, ref


def _ink_pages(n, seed, h=192, w=256):
    """White pages with a few word-shaped ink blocks."""
    rng = np.random.default_rng(seed)
    pages = []
    for _ in range(n):
        page = np.full((h, w), 255, np.uint8)
        for _ in range(5):
            x, y = int(rng.integers(8, w - 90)), int(rng.integers(8, h - 30))
            ww, th = int(rng.integers(30, 80)), int(rng.integers(12, 20))
            for gx in range(x, x + ww, int(rng.integers(5, 8))):
                page[y + int(rng.integers(0, 3)):y + th, gx:gx + 3] = int(rng.integers(0, 90))
        pages.append(page)
    return pages


def _run(side, work_dir, frames, overlay=False, **kwargs):
    parts = side
    cls = ExtractPipeline if "device" in kwargs else JaxExtractPipeline
    pipe = cls(ocr_engine=parts["engine"], classifiers=parts["classifiers"],
               indexers=parts["indexers"], work_dir=str(work_dir),
               overlay_processor=parts["overlay"] if overlay else None, **kwargs)
    meta = pipe.execute("doc.tif", "extract", frames, job_id="job-1")
    (checksum,) = os.listdir(work_dir)
    return meta, os.path.join(str(work_dir), checksum)


def _close(got, want, atol, path="$"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _close(got[k], want[k], atol, f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, atol, f"{path}[{i}]")
    elif isinstance(want, float):
        assert abs(got - want) <= atol, (path, got, want)
    else:
        assert got == want, (path, got, want)


def _json(obj):
    return json.loads(json.dumps(obj))


def test_pipeline_matches_jax(tmp_path, no_s3, tiny):
    port, ref = tiny
    frames = _ink_pages(2, 21)
    got, got_dir = _run(port, tmp_path / "port", frames, device="cpu")
    want, want_dir = _run(ref, tmp_path / "jax", frames)
    assert sum(len(p["words"]) for p in got["ocr"]) > 0
    _close(_json(got["ocr"]), _json(want["ocr"]), OCR_ATOL)
    for key in ("page_classifier", "page_indexer"):
        _close(_json(got[key]), _json(want[key]), SCORE_ATOL)
    assert set(got) == set(want)
    assert set(got["stage_times_s"]) == set(want["stage_times_s"]) == {
        "ocr", "classify_index", "render_wall", "pack", "store"}
    port_digest, jax_digest = (chip_smoke.asset_digest(d) for d in (got_dir, want_dir))
    assert port_digest == jax_digest  # listing, text, BLOBS, Adlib, PDF text layers
    with open(os.path.join(got_dir, "results.json")) as a, \
            open(os.path.join(want_dir, "results.json")) as b:
        _close(json.load(a), json.load(b), OCR_ATOL)
    assert [os.path.relpath(p, got_dir) for p in got["assets"]] == port_digest["assets"]


def test_pipeline_with_the_tiny_generator(tmp_path, no_s3, tiny, monkeypatch):
    """Dirty pages through the tiny generator: ``clean/`` as JAX's; the
    rerun reads ``clean/`` back, runs no generator and bursts nothing."""
    port, ref = tiny
    frames = chip_smoke.dirty_pages(_ink_pages(2, 22), seed=5)
    assert all(mid > 0.03 for _, mid in port["overlay"].overlay_scores(frames))
    got, got_dir = _run(port, tmp_path / "port", frames, overlay=True, device="cpu")
    want, want_dir = _run(ref, tmp_path / "jax", frames, overlay=True)
    assert "segment" in got["stage_times_s"] and "segment" in want["stage_times_s"]
    names = sorted(os.listdir(os.path.join(want_dir, "clean")))
    assert names == sorted(os.listdir(os.path.join(got_dir, "clean"))) == [
        "doc_00000.png", "doc_00001.png"]
    clean = [read_png(os.path.join(got_dir, "clean", n)) for n in names]
    for n, c in zip(names, clean):
        w = read_png(os.path.join(want_dir, "clean", n))
        d = np.abs(c.astype(np.int16) - w)
        assert c.shape == w.shape and np.mean(d == 0) >= TINY_PIXELS_EQUAL and d.max() <= 1
    tif = read_tiff(os.path.join(got_dir, "results.tif"))
    assert len(tif) == 2 and all(np.array_equal(t, c) for t, c in zip(tif, clean))
    assert os.path.samefile(os.path.join(got_dir, "results.tif"),
                            os.path.join(got_dir, "assets", "doc.tif.clean"))

    writes, calls = [], port["overlay"].calls
    real_save = port_assets.save_frame
    monkeypatch.setattr(port_assets, "save_frame",
                        lambda f, p: (writes.append(p), real_save(f, p)))
    again, again_dir = _run(port, tmp_path / "port", frames, overlay=True, device="cpu")
    assert again_dir == got_dir
    assert port["overlay"].calls == calls and writes == []
    assert again["ocr"] == got["ocr"]
    tif = read_tiff(os.path.join(got_dir, "results.tif"))
    assert all(np.array_equal(t, c) for t, c in zip(tif, clean))


def test_read_back_keeps_the_frame_layout():
    """A clean page read back in the incoming frame's layout: RGB to gray
    as PIL's ``convert("L")``, gray to RGB by stacking."""
    from PIL import Image

    from marie_tpu_torch.pipe.extract_pipeline import _in_layout

    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 256, (9, 13, 3), dtype=np.uint8)
    gray = np.zeros((9, 13), np.uint8)
    np.testing.assert_array_equal(_in_layout(rgb, gray),
                                  np.asarray(Image.fromarray(rgb).convert("L")))
    np.testing.assert_array_equal(_in_layout(gray, rgb), np.stack([gray] * 3, axis=-1))
    np.testing.assert_array_equal(_in_layout(rgb, rgb), rgb)


# --- tests/unit/test_pipeline.py's cases on the port -----------------------------

@pytest.fixture(scope="module")
def tiny_heads():
    return (LayoutDocumentClassifier(LABELS, tcfg.LayoutLMConfig.tiny(num_labels=3),
                                     device="cpu"),
            LayoutDocumentIndexer(("O", "B-KEY", "I-KEY"), tcfg.LayoutLMConfig.tiny(3),
                                  window=16, stride=8, device="cpu"))


def test_extract_pipeline_end_to_end(tmp_path, no_s3, tiny_heads):
    cls, ner = tiny_heads
    pipe = ExtractPipeline(ocr_engine=MockOcrEngine(), classifiers=[cls], indexers=[ner],
                           work_dir=str(tmp_path), renderers=("text", "pdf", "blobs", "adlib"),
                           device="cpu")
    frames = [np.full((300, 400, 3), 255, np.uint8) for _ in range(2)]
    meta = pipe.execute("doc-1", "invoice", frames, job_id="job-9")
    assert meta["ref_id"] == "doc-1" and meta["pages"] == 2 and len(meta["ocr"]) == 2
    assert len(meta["page_classifier"]) == 2 and len(meta["page_indexer"]) == 2
    names = {os.path.basename(p) for p in meta["assets"]}
    assert {"results.txt", "results.pdf", "1.BLOBS.XML", "summary.xml"} <= names


@pytest.mark.parametrize("flag,key", [("page_classifier", "page_classifier"),
                                      ("page_indexer", "page_indexer")])
def test_extract_pipeline_feature_flags(tmp_path, no_s3, tiny_heads, flag, key):
    cls, ner = tiny_heads
    pipe = ExtractPipeline(ocr_engine=MockOcrEngine(), classifiers=[cls], indexers=[ner],
                           work_dir=str(tmp_path), renderers=("text",), device="cpu")
    frames = [np.full((200, 200, 3), 255, np.uint8)]
    meta = pipe.execute("doc", "t", frames, runtime_conf={flag: {"enabled": False}})
    assert key not in meta
    other = ({"page_classifier", "page_indexer"} - {key}).pop()
    assert other in meta


def test_extract_pipeline_cleaner_flag(tmp_path, no_s3):
    class Refusing:
        def segment_batch(self, frames):
            raise AssertionError("the cleaner ran while disabled")

    pipe = ExtractPipeline(ocr_engine=MockOcrEngine(), overlay_processor=Refusing(),
                           work_dir=str(tmp_path), renderers=("text",), device="cpu")
    meta = pipe.execute("doc", "t", [np.full((64, 64), 255, np.uint8)],
                        runtime_conf={"page_cleaner": {"enabled": False}})
    assert "segment" not in meta["stage_times_s"]


def test_extract_pipeline_regions(tmp_path, no_s3):
    pipe = ExtractPipeline(ocr_engine=MockOcrEngine(), work_dir=str(tmp_path), device="cpu")
    frames = [np.full((200, 200, 3), 255, np.uint8)]
    meta = pipe.execute("doc", "t", frames,
                        regions=[{"id": "r1", "pageIndex": 0, "x": 0, "y": 0, "w": 50, "h": 50}])
    assert meta["regions"][0]["id"] == "r1"


def test_oversize_pages_are_clamped_as_jax(tmp_path, no_s3):
    """``ensure_max_page_size``: cv2's area downscale, in numpy."""
    from marie_tpu.utils.image_utils import ensure_max_page_size as jax_clamp
    from marie_tpu_torch.utils.image_utils import ensure_max_page_size

    page = np.random.default_rng(2).integers(0, 256, (3100, 1400), dtype=np.uint8)
    got, scale = ensure_max_page_size(page)
    want, want_scale = jax_clamp(page)
    assert scale == want_scale < 1 and np.array_equal(got, want)
    meta = ExtractPipeline(ocr_engine=MockOcrEngine(), work_dir=str(tmp_path),
                           renderers=("text",), device="cpu").execute("doc", "t", [page])
    assert meta["ocr"][0]["meta"]["imageSize"] == {"width": got.shape[1],
                                                   "height": got.shape[0]}


def test_entry_points_default_to_the_card(tmp_path):
    """``ExtractPipeline`` and ``DefaultOcrEngine`` run on the card unless
    asked for the CPU, and refuse without one; ``DefaultOcrEngine`` on the
    CPU reads the zoo's trained trees as the registry's ``default``
    engine does."""
    import inspect

    from marie_tpu_torch.ocr.default_ocr_engine import DefaultOcrEngine

    for entry in (ExtractPipeline, DefaultOcrEngine):
        assert inspect.signature(entry).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            ExtractPipeline(ocr_engine=MockOcrEngine(), work_dir=str(tmp_path))
        with pytest.raises(RuntimeError):
            DefaultOcrEngine()
    engine = DefaultOcrEngine(device="cpu")
    assert engine.trained == {"detector": "craft-s2d2-synth",
                              "recognizer": "trocr-fast3g2d6ov-synth"}
    # the boundary and template-matching stages take their processors
    pipe = ExtractPipeline(ocr_engine=engine, boundary_processor=object(),
                           template_matcher=object(), device="cpu")
    assert pipe.boundary_processor is not None and pipe.template_matcher is not None


def _ncc_rounding(page, box):
    """The relative error of an NCC score whose window statistics are
    summed in float32, at its typical size: sqrt(n) * eps * sum(x^2) over
    the window's variance sum((x - mean)^2), halved by the square root."""
    x, y, w, h = box
    win = chip_smoke._gray64(page)[y:y + h, x:x + w]
    var = ((win - win.mean()) ** 2).sum()
    return float(np.sqrt(win.size) * np.finfo(np.float32).eps * (win * win).sum() / (2 * var))


def test_boundary_and_template_stages_match_jax(tmp_path, no_s3):
    """Both optional stages on, OCR replayed: ``metadata["boundary"]`` (the
    deskew registration) and ``metadata["template_matching"]`` (NCC, and
    DIM and VQNNF on a seeded tiny trunk, composed, over the registered pages;
    patches of the first registered page and of an original page) as the
    JAX pipeline's: the same matches, scores within 2e-4 and, for JAX's NCC
    rows, also within the float32 rounding of their window statistics
    (``_ncc_rounding``: 1.7e-3 measured on the paper-coloured patch, whose
    variance is small); the port's stage times hold both stages."""
    from marie_tpu.components.document_registration import (
        DocumentBoundaryRegistration as JaxRegistration,
    )
    from marie_tpu.components import template_matching as J
    from marie_tpu_torch.components import template_matching as T
    from marie_tpu_torch.components.document_registration import (
        DocumentBoundaryRegistration,
    )
    from marie_tpu_torch.components.document_registration.boundary import rotate_page

    pages, ocr = _shipped([0, 1])
    frames = [rotate_page(torch.from_numpy(np.stack([p[:256, :320]] * 3, -1)),
                          np.float32(np.radians(a))).numpy() for p, a in zip(pages, (2.2, -3.1))]
    registered = [DocumentBoundaryRegistration(use_model=False, device="cpu").register(f).aligned
                  for f in frames]
    trunk = init_flax_layout(tcfg.CraftConfig.tiny(), 12)
    metas = []
    for port in (True, False):
        if port:
            matcher = T.CompositeTemplateMatcher([T.NCCTemplateMatcher(device="cpu")] + [
                cls(variables=trunk, config=tcfg.CraftConfig.tiny(), device="cpu")
                for cls in (T.DIMTemplateMatcher, T.VQNNFTemplateMatcher)])
            registration = DocumentBoundaryRegistration(use_model=False, device="cpu")
        else:
            jax_ncc = J.NCCTemplateMatcher()
            matcher = J.CompositeTemplateMatcher([jax_ncc] + [
                cls(variables=_jnp(trunk), config=jcfg.CraftConfig.tiny())
                for cls in (J.DIMTemplateMatcher, J.VQNNFTemplateMatcher)])
            registration = JaxRegistration(use_model=False)
        for k, (x, y) in enumerate(((40, 40), (150, 120), (60, 200))):
            matcher.add_template(f"patch{k}", registered[0][y:y + 32, x:x + 64])
        matcher.add_template("original", pages[0][40:72, 40:120])
        kwargs = dict(ocr_engine=chip_smoke.ReplayOcr(ocr), classifiers=[], indexers=[],
                      boundary_processor=registration, template_matcher=matcher,
                      work_dir=str(tmp_path / str(port)))
        cls = ExtractPipeline if port else JaxExtractPipeline
        metas.append(cls(**kwargs, **({"device": "cpu"} if port else {})).execute(
            "doc.tif", "extract", frames, runtime_conf={"page_boundary": {"enabled": True}}))
    got, want = metas
    assert [b["page"] for b in got["boundary"]] == [0, 1]
    _close(_json(got["boundary"]), _json(want["boundary"]), 1e-4)
    assert len(got["template_matching"]) >= 3

    def ordered(rows):  # matches whose scores tie within the limit come in either order
        return sorted(_json(rows), key=lambda m: (m["frame_index"], m["label"], m["bbox"]))

    got_tm, want_tm = ordered(got["template_matching"]), ordered(want["template_matching"])
    assert [{**m, "score": None} for m in got_tm] == [{**m, "score": None} for m in want_tm]
    ncc_rows = {(m.frame_index, m.label, tuple(m.bbox)) for m in jax_ncc.match(registered)}
    assert ncc_rows
    for g, w in zip(got_tm, want_tm):
        key = (w["frame_index"], w["label"], tuple(w["bbox"]))
        limit = 2e-4
        if key in ncc_rows:  # JAX's NCC window statistics are float32, the port's float64
            limit += w["score"] * _ncc_rounding(registered[key[0]], key[2])
        assert abs(g["score"] - w["score"]) <= limit, (key, g["score"], w["score"])
    assert {"boundary", "template_matching"} <= set(got["stage_times_s"])
    assert set(want["stage_times_s"]) == set(got["stage_times_s"]) - {"boundary"}
