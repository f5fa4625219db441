"""The page forms and page segmentation modes the port's engine took over
from the JAX engine, held against it on the CPU at small sizes: RGB
pages with distinct channels (fused and two-phase), pages over the
largest bucket (scaled down with cv2's ``INTER_AREA`` arithmetic),
WORD / RAW_LINE / MULTI_LINE host fragments (resized with cv2's
``INTER_LINEAR`` arithmetic), regions, the 4-D crop, the resizes
themselves against cv2, and the registry, mock engine, ``meta_to_text``
and result checker.

Result dicts are compared as in ``tests/test_torch_engine.py``: equal
texts, boxes, lines and meta, confidences within 1e-3 (they are rounded
to 3 decimals).  Both engines run float32 tiny configs with the same
seeded weights and ink boxes.
"""

import cv2
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from marie_tpu.boxes.craft_box_processor import BoxProcessorCraft as JaxBoxProcessorCraft
from marie_tpu.document.trocr_ocr_processor import TrOcrProcessor as JaxTrOcrProcessor
from marie_tpu.enums import CoordinateFormat as JaxCoordinateFormat
from marie_tpu.enums import PSMode as JaxPSMode
from marie_tpu.models import configs as jcfg
from marie_tpu.ocr.ocr_engine import PipelineOcrEngine as JaxEngine
from marie_tpu.preprocess import BucketSpec as JaxBucketSpec
from marie_tpu.preprocess.ops import crop_resize_pages as jax_crop_resize_pages
from marie_tpu_torch.boxes.craft_box_processor import BoxProcessorCraft
from marie_tpu_torch.document.trocr_ocr_processor import TrOcrProcessor
from marie_tpu_torch.enums import CoordinateFormat, PSMode
from marie_tpu_torch.models import configs as tcfg
from marie_tpu_torch.ocr.ocr_engine import PipelineOcrEngine
from marie_tpu_torch.preprocess.buckets import BucketSpec
from marie_tpu_torch.preprocess.ops import crop_resize_pages
from marie_tpu_torch.preprocess.resize import resize_area_u8, resize_linear_u8
from marie_tpu_torch.registry.convert import init_flax_layout

H, W = 96, 128
BUCKETS = ((H, W), (2 * H, W))
CONF_ATOL = 1e-3


def _page(seed: int, h: int = H, w: int = W, n_words: int = 4) -> np.ndarray:
    """A white [h, w] page with word-shaped ink blocks at seeded places."""
    rng = np.random.default_rng(seed)
    page = np.full((h, w), 255, np.uint8)
    for _ in range(n_words):
        ww, th = int(rng.integers(16, 40)), int(rng.integers(8, 14))
        x, y = int(rng.integers(4, w - ww - 4)), int(rng.integers(4, h - th - 4))
        level = int(rng.integers(0, 90))
        for gx in range(x, x + ww, int(rng.integers(4, 6))):
            page[y + int(rng.integers(0, 2)):y + th, gx:gx + 2] = level
        page[y + th // 2:y + th // 2 + 2, x:x + ww] = level
    return page


def _colour(page: np.ndarray) -> np.ndarray:
    """Tinted paper and coloured ink: distinct channels."""
    g = page.astype(np.float32)[..., None] / 255.0
    ink, paper = np.float32([30, 40, 120]), np.float32([250, 240, 220])
    return np.rint(ink + (paper - ink) * g).astype(np.uint8)


@pytest.fixture(scope="module")
def processors():
    """(JAX (bp, op), port (bp, op)) with the same float32 tiny weights."""
    craft_tree = init_flax_layout(tcfg.CraftConfig.tiny(), 7)
    trocr_tree = init_flax_layout(tcfg.TrOCRConfig.tiny(), 8)
    jbp = JaxBoxProcessorCraft(
        config=jcfg.CraftConfig.tiny(), box_source="ink", max_components=32,
        variables=jax.tree_util.tree_map(jnp.asarray, craft_tree),
        bucket_spec=JaxBucketSpec(shapes=BUCKETS))
    jop = JaxTrOcrProcessor(config=jcfg.TrOCRConfig.tiny(), batch_sizes=(4, 8),
                            params=jax.tree_util.tree_map(jnp.asarray, trocr_tree))
    tbp = BoxProcessorCraft(tcfg.CraftConfig.tiny(), craft_tree, box_source="ink",
                            max_components=32, bucket_spec=BucketSpec(shapes=BUCKETS),
                            device="cpu")
    top = TrOcrProcessor(tcfg.TrOCRConfig.tiny(), trocr_tree, batch_sizes=(4, 8),
                         device="cpu")
    return (jbp, jop), (tbp, top)


def _extract_both(procs, pages, pms_mode="sparse", coordinate_format="xywh",
                  regions=None, **engine_kw):
    (jbp, jop), (tbp, top) = procs
    got = PipelineOcrEngine(tbp, top, **engine_kw).extract(
        pages, PSMode.from_value(pms_mode), CoordinateFormat(coordinate_format),
        regions=regions)
    want = JaxEngine(jbp, jop, **engine_kw).extract(
        pages, JaxPSMode.from_value(pms_mode), JaxCoordinateFormat(coordinate_format),
        regions=regions)
    return got, want


def _strip(results):
    return [dict(r, words=[dict(w, confidence=None) for w in r["words"]],
                 lines=[dict(ln, confidence=None) for ln in r.get("lines", [])],
                 confidence=None)
            for r in results]


def assert_same_results(got, want):
    assert _strip(got) == _strip(want)
    confs = [[w["confidence"] for r in rs for w in r["words"]]
             + [ln["confidence"] for r in rs for ln in r.get("lines", [])]
             + [r["confidence"] for r in rs if "confidence" in r] for rs in (got, want)]
    np.testing.assert_allclose(*confs, rtol=0, atol=CONF_ATOL)


def _n_words(results):
    return sum(len(r["words"]) for r in results)


@pytest.mark.parametrize("upload_format", ["u8", "u2"])
def test_rgb_pages_match_jax(processors, upload_format):
    """A group of colour pages runs RGB (uploaded u8 whatever the format,
    cropped with stock ops); a grayscale page beside it forms its own
    group; the row budget overflows into the per-page path on the RGB
    page."""
    pages = [_colour(_page(1, n_words=6)), _colour(_page(2, n_words=8)), _page(3)]
    got, want = _extract_both(processors, pages, page_fuse_batch=2, compact_slots=1,
                              upload_format=upload_format)
    assert_same_results(got, want)
    assert _n_words(got[:2]) > 2  # past the group's 2 x 1 rows


def test_rgb_page_two_phase_matches_jax(processors):
    """The two-phase path keeps a colour page's channels on the device."""
    pages = [_colour(_page(4)), np.repeat(_page(5)[..., None], 3, -1)]
    got, want = _extract_both(processors, pages, single_program=False)
    assert_same_results(got, want)
    assert _n_words(got) > 2


@pytest.mark.parametrize("shape", [(4 * H, W), (3 * H + 7, 2 * W + 50)])
def test_oversize_page_matches_jax(processors, shape):
    """Pages over the largest bucket are scaled into it (by 1/2 exactly, and
    by factors that are not integers); boxes come back in page pixels."""
    h, w = shape
    page = _page(6, h, w, n_words=8)
    got, want = _extract_both(processors, [page, _colour(page)], page_fuse_batch=2)
    assert_same_results(got, want)
    assert _n_words(got) > 0
    for wd in got[0]["words"]:
        x, y, bw, bh = wd["box"]
        assert x + bw <= w and y + bh <= h


@pytest.mark.parametrize("pms_mode,coordinate_format", [
    ("word", "xywh"), ("raw_line", "xyxy"), ("multiline", "xywh"), ("multiline", "xyxy")])
def test_fragment_modes_match_jax(processors, pms_mode, coordinate_format):
    """WORD / RAW_LINE take the whole image, MULTI_LINE the lines of its
    ink projection; every fragment goes through the width buckets and the
    batch chunks (here 12 lines over chunks of 8)."""
    pages = [_page(7, n_words=12), _colour(_page(8)), _page(9)[:20, :70]]
    got, want = _extract_both(processors, pages, pms_mode, coordinate_format)
    assert_same_results(got, want)
    assert got[0]["meta"]["format"] == coordinate_format
    assert _n_words(got) >= 3


def test_regions_match_jax(processors):
    """Regions in every mode (RAW_LINE by default), off the page edge
    too; a missing key or a page past the frames raises as in JAX."""
    pages = [_page(10), _colour(_page(11))]
    regions = [
        {"id": 1, "pageIndex": 0, "x": 4, "y": 10, "w": 60, "h": 30},
        {"id": "b", "pageIndex": 1, "x": 0, "y": 0, "w": W, "h": H // 2, "mode": "sparse"},
        {"id": 3, "pageIndex": 1, "x": 10, "y": 20, "w": 90, "h": 60, "mode": "multiline"},
        {"id": 4, "pageIndex": 0, "x": -5, "y": 50, "w": 80, "h": 80, "mode": "word"},
    ]
    got, want = _extract_both(processors, pages, regions=regions)
    assert [r["id"] for r in got] == [1, "b", 3, 4]
    assert_same_results(got, want)
    (_, _), (tbp, top) = processors
    engine = PipelineOcrEngine(tbp, top)
    with pytest.raises(ValueError, match="Required key"):
        engine.extract(pages, regions=[{"id": 1, "pageIndex": 0, "x": 0, "y": 0, "w": 4}])
    with pytest.raises(ValueError, match="out of range"):
        engine.extract(pages, regions=[dict(regions[0], pageIndex=2)])


def test_recognize_from_fragments_matches_jax(processors):
    """Fragments of every width bucket, grayscale and RGB, exactly half the
    crop height (cv2's 2x2 area path), blank, and more than one chunk."""
    (_, jop), (_, top) = processors
    rng = np.random.default_rng(12)
    page = _page(13, 2 * H, 2 * W, n_words=16)
    frags = []
    for i in range(19):
        fh, fw = int(rng.integers(6, 70)), int(rng.integers(4, 200))
        y, x = int(rng.integers(0, 2 * H - fh)), int(rng.integers(0, 2 * W - fw))
        frag = page[y:y + fh, x:x + fw]
        frags.append(_colour(frag) if i % 3 == 0 else frag)
    frags.append(page[:2 * top.crop_h, :2 * 40])  # halved on both sides
    frags.append(np.full((10, 30), 255, np.uint8))
    got = top.recognize_from_fragments(frags)
    want = jop.recognize_from_fragments(frags)
    assert [w["text"] for w in got] == [w["text"] for w in want]
    np.testing.assert_allclose([w["confidence"] for w in got],
                               [w["confidence"] for w in want], rtol=0, atol=1e-5)
    for frag in frags:
        np.testing.assert_array_equal(top._prep_fragment(frag), jop._prep_fragment(frag))
    assert top.recognize_from_fragments([]) == []


@pytest.mark.parametrize("chans", [None, 1, 3])
def test_crop_resize_pages_rgb_matches_jax(chans):
    """The 4-D crop (interleaved gather, float after it) bit for bit."""
    rng = np.random.default_rng(14)
    shape = (3, 50, 70) if chans is None else (3, 50, 70, chans)
    pages = rng.integers(0, 256, shape, dtype=np.uint8)
    n = 24
    x0, y0 = rng.uniform(-5, 60, n), rng.uniform(-5, 40, n)
    boxes = np.stack([x0, y0, x0 + rng.uniform(0, 50, n), y0 + rng.uniform(0, 25, n)],
                     -1).astype(np.float32)
    pid = rng.integers(0, 3, n).astype(np.int32)
    want, want_w = jax_crop_resize_pages(jnp.asarray(pages), jnp.asarray(pid),
                                         jnp.asarray(boxes), 16, 40)
    got, got_w = crop_resize_pages(torch.from_numpy(pages), torch.from_numpy(pid),
                                   torch.from_numpy(boxes), 16, 40)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))


_IMAGES = st.tuples(st.integers(1, 90), st.integers(1, 90), st.sampled_from([0, 3, 4]),
                    st.integers(0, 2**31 - 1))


def _image(h, w, c, seed):
    rng = np.random.default_rng(seed)
    shape = (h, w) if c == 0 else (h, w, c)
    if seed % 2:  # text-like: mostly white and black
        return np.where(rng.random(shape) < 0.7, 255, rng.integers(0, 80, shape)).astype(np.uint8)
    return rng.integers(0, 256, shape, dtype=np.uint8)


@settings(max_examples=80, deadline=None)
@given(_IMAGES, st.floats(0.05, 1.0), st.floats(0.05, 1.0), st.integers(1, 4))
def test_resize_area_matches_cv2(image, fx, fy, factor):
    """Any downscale, and integer factors on both sides (cv2's cell
    average), bit for bit."""
    h, w, c, seed = image
    img = _image(h, w, c, seed)
    size = (max(1, int(w * fx)), max(1, int(h * fy)))
    np.testing.assert_array_equal(resize_area_u8(img, size),
                                  cv2.resize(img, size, interpolation=cv2.INTER_AREA))
    img = _image(h * factor, w * (factor % 3 + 1), c, seed)
    np.testing.assert_array_equal(resize_area_u8(img, (w, h)),
                                  cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA))


@settings(max_examples=80, deadline=None)
@given(_IMAGES, st.integers(1, 200), st.integers(1, 120), st.booleans())
def test_resize_linear_matches_cv2(image, dw, dh, halve):
    """Up, down and mixed scales, and exact halving (cv2's 2x2 area
    path), bit for bit."""
    h, w, c, seed = image
    img = _image(h, w, c, seed)
    if halve:
        img, dw, dh = _image(2 * h, 2 * w, c, seed), w, h
    np.testing.assert_array_equal(resize_linear_u8(img, (dw, dh)),
                                  cv2.resize(img, (dw, dh), interpolation=cv2.INTER_LINEAR))


def test_resize_refuses_what_cv2_does_not_share():
    img = np.zeros((8, 8), np.uint8)
    with pytest.raises(ValueError):
        resize_area_u8(img, (16, 4))  # cv2's area mode grows by bilinear
    with pytest.raises(ValueError):
        resize_linear_u8(img.astype(np.float32), (4, 4))
    np.testing.assert_array_equal(resize_linear_u8(img + 3, (8, 8)), img + 3)


def test_extract_bounding_boxes_matches_jax(processors):
    (jbp, _), (tbp, _) = processors
    page = _colour(_page(15, n_words=6))
    for mode in ("word", "raw_line", "multiline", "sparse", "line"):
        got = tbp.extract_bounding_boxes("q", "c", page, PSMode.from_value(mode))
        want = jbp.extract_bounding_boxes("q", "c", page, JaxPSMode.from_value(mode))
        np.testing.assert_array_equal(got[0], want[0])
        assert len(got[1]) == len(want[1]) and all(
            np.array_equal(a, b) for a, b in zip(got[1], want[1]))
        np.testing.assert_array_equal(got[2], want[2])
        assert got[3] == want[3]
        np.testing.assert_array_equal(got[4], want[4])


def test_mock_engine_meta_to_text_and_check_match_jax(tmp_path):
    from marie_tpu.check import compare_results as jax_compare
    from marie_tpu.ocr.mock_ocr_engine import MockOcrEngine as JaxMock
    from marie_tpu.ocr.util import meta_to_text as jax_meta_to_text
    from marie_tpu_torch.check import compare_results
    from marie_tpu_torch.ocr.mock_ocr_engine import MockOcrEngine
    from marie_tpu_torch.ocr.util import get_known_ocr_engines, meta_to_text

    pages = [_page(16), np.zeros((40, 60, 3), np.uint8)]
    for fmt in ("xywh", "xyxy"):
        got = MockOcrEngine().extract(pages, coordinate_format=CoordinateFormat(fmt))
        assert got == JaxMock().extract(pages, coordinate_format=JaxCoordinateFormat(fmt))
    regions = [{"id": 7}]
    assert MockOcrEngine().extract(pages, regions=regions) == JaxMock().extract(
        pages, regions=regions)
    results = JaxMock().extract(pages)
    results[1]["words"] = []
    path = tmp_path / "meta.json"
    import json

    path.write_text(json.dumps(results))
    assert meta_to_text(str(path), str(tmp_path / "a.txt")) == jax_meta_to_text(
        str(path), str(tmp_path / "b.txt"))
    assert (tmp_path / "a.txt").read_text() == (tmp_path / "b.txt").read_text()
    cand = JaxMock(text="mock").extract(pages)
    cand[0]["words"][1]["text"] = "mo"
    cand[0]["words"][2]["box"] = [0, 0, 3, 3]
    assert compare_results(results, cand) == jax_compare(results, cand)
    assert get_known_ocr_engines("cpu", "mock")["mock"].extract(pages) == JaxMock().extract(pages)
    with pytest.raises(ValueError):
        get_known_ocr_engines("cpu", "worst")
