"""The port's serving engine (``PipelineOcrEngine`` over ``BoxProcessorCraft``
and ``TrOcrProcessor``) against the JAX package's engine, case for case
with ``tests/unit/test_fused_ocr.py``: every ``extract`` result dict of
the port equals the JAX engine's on the same pages and weights (texts,
boxes, lines, line texts and boxes, ``meta``; confidences within 1e-3,
since ``assemble_page_result`` rounds them to 3 decimals and a float32
difference can move one step).

Pages are white with word-shaped ink blocks drawn from a seed; detection
runs on ink (``box_source="ink"``), except for one case that feeds both
engines the same CRAFT heatmap through a stand-in detector.
"""

import types

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp

from marie_tpu.boxes.craft_box_processor import BoxProcessorCraft as JaxBoxProcessorCraft
from marie_tpu.document.trocr_ocr_processor import TrOcrProcessor as JaxTrOcrProcessor
from marie_tpu.enums import CoordinateFormat as JaxCoordinateFormat
from marie_tpu.enums import PSMode as JaxPSMode
from marie_tpu.models import configs as jcfg
from marie_tpu.models.craft import CRAFT as JaxCRAFT
from marie_tpu.ocr.ocr_engine import PipelineOcrEngine as JaxEngine
from marie_tpu.preprocess import BucketSpec as JaxBucketSpec
from marie_tpu_torch.boxes.craft_box_processor import BoxProcessorCraft
from marie_tpu_torch.document.trocr_ocr_processor import TrOcrProcessor
from marie_tpu_torch.enums import CoordinateFormat, PSMode
from marie_tpu_torch.models import configs as tcfg
from marie_tpu_torch.ocr import fused as tfused
from marie_tpu_torch.ocr.ocr_engine import PipelineOcrEngine
from marie_tpu_torch.preprocess.buckets import BucketSpec
from marie_tpu_torch.registry.convert import init_flax_layout

H, W = 256, 384
BUCKETS = ((H, W), (2 * H, W))
CONF_ATOL = 1e-3


def _page(seed: int, h: int = H, w: int = W, n_words: int = 3,
          narrow: int = 0) -> np.ndarray:
    """A white [h, w] page with ``n_words`` word-shaped ink blocks (glyph
    strokes of one random darkness, ~16 px tall) at seeded positions, the
    last ``narrow`` of them 8-16 px wide (crops short enough that a
    geometric decode-step cap would cut them)."""
    rng = np.random.default_rng(seed)
    page = np.full((h, w), 255, np.uint8)
    for i in range(n_words):
        ww = int(rng.integers(8, 16) if i >= n_words - narrow else rng.integers(30, 90))
        th = int(rng.integers(12, 20))
        x, y = int(rng.integers(8, w - ww - 8)), int(rng.integers(8, h - th - 8))
        level = int(rng.integers(0, 90))
        for gx in range(x, x + ww, int(rng.integers(5, 8))):
            page[y + int(rng.integers(0, 3)):y + th, gx:gx + int(rng.integers(2, 4))] = level
        page[y + th // 2:y + th // 2 + 2, x:x + ww] = level
    return page


@pytest.fixture(scope="module")
def processors():
    """(JAX (bp, op), port (bp, op)) with the same weights: float32 tiny
    configs, ink boxes, recognition chunks of 8 and 32."""
    craft_tree = init_flax_layout(tcfg.CraftConfig.tiny(), 7)
    trocr_tree = init_flax_layout(tcfg.TrOCRConfig.tiny(), 8)
    jbp = JaxBoxProcessorCraft(
        config=jcfg.CraftConfig.tiny(), box_source="ink", max_components=64,
        variables=jax.tree_util.tree_map(jnp.asarray, craft_tree),
        bucket_spec=JaxBucketSpec(shapes=BUCKETS))
    jop = JaxTrOcrProcessor(config=jcfg.TrOCRConfig.tiny(), batch_sizes=(8, 32),
                            params=jax.tree_util.tree_map(jnp.asarray, trocr_tree))
    tbp = BoxProcessorCraft(tcfg.CraftConfig.tiny(), craft_tree, box_source="ink",
                            max_components=64, bucket_spec=BucketSpec(shapes=BUCKETS),
                            device="cpu")
    top = TrOcrProcessor(tcfg.TrOCRConfig.tiny(), trocr_tree, batch_sizes=(8, 32),
                         device="cpu")
    return (jbp, jop), (tbp, top)


def _extract_both(procs, pages, pms_mode="sparse", coordinate_format="xywh", **engine_kw):
    """(port results, JAX results) of ``extract`` with the same engine
    settings."""
    (jbp, jop), (tbp, top) = procs
    got = PipelineOcrEngine(tbp, top, **engine_kw).extract(
        pages, PSMode(pms_mode), CoordinateFormat(coordinate_format))
    want = JaxEngine(jbp, jop, **engine_kw).extract(
        pages, JaxPSMode(pms_mode), JaxCoordinateFormat(coordinate_format))
    return got, want


def _without_conf(results):
    out = []
    for r in results:
        r = dict(r, words=[dict(w, confidence=None) for w in r["words"]],
                 lines=[dict(ln, confidence=None) for ln in r["lines"]])
        out.append(r)
    return out


def _confs(results):
    return np.asarray([w["confidence"] for r in results for w in r["words"]]
                      + [ln["confidence"] for r in results for ln in r["lines"]])


def assert_same_results(got, want):
    """Result dicts equal, confidences within CONF_ATOL."""
    assert _without_conf(got) == _without_conf(want)
    np.testing.assert_allclose(_confs(got), _confs(want), rtol=0, atol=CONF_ATOL)


def _words(results):
    return [([w["text"] for w in r["words"]], [w["box"] for w in r["words"]])
            for r in results]


def _n_words(results):
    return sum(len(r["words"]) for r in results)


def test_single_program_matches_two_phase(processors):
    pages = [_page(s) for s in range(3)]
    fused, want = _extract_both(processors, pages, single_program=True, page_fuse_batch=1)
    assert_same_results(fused, want)
    two_phase, want2 = _extract_both(processors, pages, single_program=False)
    assert_same_results(two_phase, want2)
    assert _words(fused) == _words(two_phase) and _n_words(fused) > 0


def test_page_batched_with_ladder_padding(processors):
    """5 same-bucket pages at page_fuse_batch=4: a group of 4 plus one;
    3 pages: one group padded up the ladder to 4."""
    _, (tbp, top) = processors
    two_phase = PipelineOcrEngine(tbp, top, single_program=False)
    for n in (5, 3, 1):
        pages = [_page(s) for s in range(n)]
        got, want = _extract_both(processors, pages, page_fuse_batch=4)
        assert len(got) == n
        assert_same_results(got, want)
        assert _words(got) == _words(two_phase.extract(pages))


def test_mixed_buckets_split_groups(processors):
    _, (tbp, top) = processors
    pages = [_page(0, 250), _page(1, 250), _page(2, 500), _page(3, 250)]
    got, want = _extract_both(processors, pages, page_fuse_batch=4)
    assert_same_results(got, want)
    two_phase = PipelineOcrEngine(tbp, top, single_program=False)
    assert _words(got) == _words(two_phase.extract(pages))


def test_rec_slots_overflow_falls_back(processors):
    """Rows past the group's budget (2 pages x 2 rows) go through the
    processor's recognize_dispatch, with the organized integer boxes on
    the page as uploaded, as in the JAX engine, decoded with no step
    caps; single pages keep the default budget (``rec_slots`` is unused
    on both sides).  The narrow words make the step caps bind: in-budget
    rows are capped by their crop width (in both engines), so here the
    fused path is held to the JAX engine, not to the two-phase path."""
    pages = [_page(s, n_words=6, narrow=3) for s in range(2)]
    for kw in (dict(page_fuse_batch=1, rec_slots=2),
               dict(page_fuse_batch=2, compact_slots=2)):
        got, want = _extract_both(processors, pages, **kw)
        assert_same_results(got, want)
    assert _n_words(got) > 4  # the 4-row budget overflowed


@pytest.mark.parametrize("upload_format", ["u8", "u4", "u2", "u1", "u1d"])
@pytest.mark.parametrize("coordinate_format", ["xywh", "xyxy"])
@pytest.mark.parametrize("pms_mode", ["sparse", "line"])
def test_extract_matches_jax(processors, pms_mode, coordinate_format, upload_format):
    """Every mode and box format the fused path takes, every upload
    format, with the 8-row budget of two 2-page groups overflowing."""
    pages = [_page(10 + s, n_words=5) for s in range(4)]
    got, want = _extract_both(processors, pages, pms_mode, coordinate_format,
                              page_fuse_batch=2, compact_slots=4,
                              upload_format=upload_format)
    assert_same_results(got, want)
    assert _n_words(got) > 16
    assert got[0]["meta"]["format"] == coordinate_format
    if pms_mode == "line":
        assert all(len(r["lines"]) == len(r["words"]) for r in got)


def test_compact_budget_borrowing(processors):
    """A dense page borrows the rows a sparse page leaves unused."""
    dense, sparse = _page(1, n_words=5), _page(2, n_words=1)
    for pages in ([dense, sparse], [sparse, dense]):
        got, want = _extract_both(processors, pages, page_fuse_batch=2, compact_slots=4)
        assert_same_results(got, want)


def test_grayscale_2d_frames_match_rgb(processors):
    """2-D grayscale frames and their RGB triplicates give the same
    results; an RGB page whose channels differ in one pixel runs as RGB
    and equals the JAX engine (``tests/test_torch_forms.py`` covers RGB
    pages further)."""
    _, (tbp, top) = processors
    gray = [_page(s) for s in range(3)]
    rgb = [np.repeat(p[..., None], 3, -1) for p in gray]
    got, want = _extract_both(processors, rgb, page_fuse_batch=2)
    assert_same_results(got, want)
    engine = PipelineOcrEngine(tbp, top, page_fuse_batch=2)
    assert engine.extract(gray) == got
    color = rgb[0].copy()
    color[0, 0] = (1, 2, 3)
    got, want = _extract_both(processors, [color], page_fuse_batch=2)
    assert_same_results(got, want)
    assert _words(got) == _words(engine.extract([gray[0]]))


def test_detector_accepts_2d_page(processors):
    """detect_words takes a 2-D page and its RGB triplicate alike, and
    equals the JAX detector."""
    (jbp, _), (tbp, _) = processors
    page = _page(4)
    b_gray, s_gray = tbp.detect_words(page)
    b_rgb, _ = tbp.detect_words(np.repeat(page[..., None], 3, -1))
    jb, js = jbp.detect_words(np.repeat(page[..., None], 3, -1))
    assert np.array_equal(b_gray, b_rgb) and len(b_gray) > 0
    np.testing.assert_array_equal(b_gray, jb)
    np.testing.assert_array_equal(s_gray, js)


def test_blank_page_in_group(processors):
    blank = np.full((H, W), 255, np.uint8)
    got, want = _extract_both(processors, [blank, _page(9)], page_fuse_batch=2)
    assert_same_results(got, want)
    assert got[0]["words"] == [] and got[0]["lines"] == []
    assert len(got[1]["words"]) > 0


def test_dispatch_stream_order_and_bounding(processors, monkeypatch):
    """The stream yields group handles in page order with max_in_flight=1,
    and extract hands each group's results over as they are assembled.
    With one handle taken and max_in_flight=1 the worker dispatches at
    most one more group and computes a third, then waits."""
    import time

    _, (tbp, top) = processors
    pages = [_page(s) for s in range(5)]
    upload, uploads = tfused._upload_group, []
    monkeypatch.setattr(tfused, "_upload_group",
                        lambda *a, **k: uploads.append(1) or upload(*a, **k))
    stream = tfused.fused_dispatch_stream(tbp, top, pages, page_batch=1, max_in_flight=1)
    next(stream)
    time.sleep(1.0)
    assert len(uploads) <= 3
    assert len(list(stream)) == 4 and len(uploads) == 5
    handles = list(tfused.fused_dispatch_stream(
        tbp, top, pages, page_batch=2, compact_slots=8, max_in_flight=1))
    # 5 pages at page_batch=2 -> groups of 2, 2, 1
    assert [tfused.handle_page_count(h) for h in handles] == [2, 2, 1]
    assert [h.pages.shape[0] for h in handles] == [2, 2, 1]
    many = tfused.fused_dispatch_many(tbp, top, pages, page_batch=2, compact_slots=8)
    assert [tfused.handle_page_count(h) for h in many] == [2, 2, 1]
    assert all(torch.equal(a.tokens, b.tokens) for a, b in zip(handles, many))
    engine = PipelineOcrEngine(tbp, top, page_fuse_batch=4)
    streamed = []
    whole = engine.extract(pages, on_result_group=lambda r, s: streamed.append((s, r)),
                           group_size=2)
    assert [s for s, _ in streamed] == [0, 2, 4]
    assert [r for _, rs in streamed for r in rs] == whole
    assert [r["meta"]["page"] for r in whole] == list(range(5))


def test_dispatch_stream_propagates_worker_errors(processors, monkeypatch):
    """An exception on the upload/dispatch worker thread surfaces in the
    consuming thread instead of hanging the stream."""
    _, (tbp, top) = processors

    def boom(*a, **k):
        raise RuntimeError("upload failed")

    monkeypatch.setattr(tfused, "_upload_group", boom)
    pages = [_page(s) for s in range(2)]
    with pytest.raises(RuntimeError, match="upload failed"):
        list(tfused.fused_dispatch_stream(tbp, top, pages, page_batch=2))


def test_engine_refuses_what_is_not_ported(processors, monkeypatch):
    """The engine's ``mesh``: ``"local"`` on one device is no mesh, as in
    the JAX engine; a port mesh is taken as it is; any other object is
    refused with ``TypeError``, and a page group that does not divide by
    the mesh's entries raises ``ValueError`` in the page program.  The
    other CC stats variants are ported:
    ``cc_stats="sort"`` gives the JAX detector's stats under
    ``MARIE_CC_STATS=sort``.  Beam search and the ``best`` engine are
    ported: a beam processor builds (and is kept off the fused path, as
    in JAX) and the registry builds ``best``; a bad beam size or engine
    name is refused."""
    from marie_tpu_torch.boxes.craft_box_processor import detect_core
    from marie_tpu_torch.ocr.fused import supports_fused_page
    from marie_tpu_torch.ocr.util import get_known_ocr_engines
    from marie_tpu_torch.ocr.voting_ocr_engine import VotingOcrEngine

    (jbp, _), (tbp, top) = processors
    from marie_tpu_torch.parallel import create_mesh

    assert PipelineOcrEngine(tbp, top, mesh="local").mesh is None
    mesh = create_mesh((2,), ("pages",), devices=["cpu", "cpu"])
    assert PipelineOcrEngine(tbp, top, mesh=mesh).mesh is mesh
    with pytest.raises(TypeError, match="mesh must be"):
        PipelineOcrEngine(tbp, top, mesh=object())
    with pytest.raises(ValueError, match="not divisible by mesh devices 2"):
        tfused.fused_ocr_pages(tbp, top, np.stack([_page(s) for s in (3, 4, 5)]), mesh=mesh)
    with pytest.raises(ValueError):
        PipelineOcrEngine(tbp, top, upload_format="u3")
    beam = TrOcrProcessor(tcfg.TrOCRConfig.tiny(), beam_size=5, device="cpu")
    assert beam.beam_size == 5 and not supports_fused_page(tbp, beam)
    with pytest.raises(ValueError):
        TrOcrProcessor(tcfg.TrOCRConfig.tiny(), beam_size=0, device="cpu")
    from marie_tpu.boxes.craft_box_processor import _detect_core as jax_detect_core

    pages = np.stack([_page(s) for s in (3, 4)])
    got = detect_core(tbp.model, torch.from_numpy(pages), 0.7, 0.4, 0.4, 8, "ink",
                      cc_stats="sort")
    monkeypatch.setenv("MARIE_CC_STATS", "sort")
    want = jax_detect_core(jbp.model, jbp.variables, jnp.asarray(pages), 0.7, 0.4, 0.4, 8,
                           "ink")
    assert int(np.asarray(want["valid"]).sum()) > 0
    for key, v in want.items():
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(v), err_msg=key)
    assert isinstance(get_known_ocr_engines("cpu", "best")["best"], VotingOcrEngine)
    with pytest.raises(ValueError):
        get_known_ocr_engines("cpu", "worst")


class _JaxFixedHeat:
    """Stand-in CRAFT for the JAX engine: returns the heatmap it is given
    as its variables."""

    cfg = types.SimpleNamespace(out_stride=2)

    def apply(self, variables, x):
        return variables["heat"]


class _TorchFixedHeat(nn.Module):
    def __init__(self, heat: np.ndarray):
        super().__init__()
        self.heat = nn.Parameter(torch.from_numpy(heat), requires_grad=False)
        self.cfg = types.SimpleNamespace(out_stride=2)

    def forward(self, x):
        return self.heat


@pytest.mark.parametrize("pms_mode", ["sparse", "line"])
def test_heatmap_extract_matches_jax(processors, pms_mode):
    """The production mask (box_source="heatmap") on one 2-page group,
    both engines fed the JAX CRAFT heatmap of those pages through a
    stand-in detector, with thresholds at its 0.6 and 0.8 quantiles (so
    the random-weight map forms components) and a row budget that
    overflows."""
    (jbp, jop), (tbp, top) = processors
    pages = [_page(20 + s, n_words=5) for s in range(2)]
    craft_tree = init_flax_layout(tcfg.CraftConfig.tiny(), 7)
    rgb = jnp.asarray(np.repeat(np.stack(pages)[..., None], 3, -1).astype(np.float32) / 255.0)
    heat = np.array(JaxCRAFT(jcfg.CraftConfig.tiny()).apply(
        jax.tree_util.tree_map(jnp.asarray, craft_tree), rgb))
    low_text = float(np.quantile(heat[..., 0], 0.6))
    text_threshold = float(np.quantile(heat[..., 0], 0.8))
    kw = dict(box_source="heatmap", text_threshold=text_threshold, low_text=low_text,
              max_components=64, min_area=4)
    jbp_h = JaxBoxProcessorCraft(config=jcfg.CraftConfig.tiny(), variables={"heat": heat},
                                 bucket_spec=JaxBucketSpec(shapes=((H, W),)), **kw)
    jbp_h.model = _JaxFixedHeat()
    tbp_h = BoxProcessorCraft(tcfg.CraftConfig.tiny(), craft_tree, device="cpu",
                              bucket_spec=BucketSpec(shapes=((H, W),)), **kw)
    tbp_h.model = _TorchFixedHeat(heat)
    got, want = _extract_both(((jbp_h, jop), (tbp_h, top)), pages, pms_mode,
                              page_fuse_batch=2, compact_slots=3)
    assert_same_results(got, want)
    assert _n_words(got) > 6


def test_recognize_dispatch_matches_jax(processors):
    """The overflow path's crop + decode: the port crops the grayscale
    device page with K1 (plain version here) and expands the crops to 3
    channels, the JAX processor crops the page's three equal channels;
    the crops are bit-identical and the words equal, across two chunks
    (32 + 8 rows, padded with dummy boxes) that include a box taller than
    the JAX Pallas crop window (224 rows) and boxes on the page edges."""
    from marie_tpu.document.trocr_ocr_processor import _crop_batch_on_device
    from marie_tpu_torch.ops.kernels.crop_resize import crop_resize

    (_, jop), (_, top) = processors
    page = _page(30, 2 * H, W, n_words=12)
    rng = np.random.default_rng(31)
    n = 40
    xywh = np.stack([rng.uniform(0, W - 60, n), rng.uniform(0, 2 * H - 40, n),
                     rng.uniform(4, 120, n), rng.uniform(6, 40, n)], -1).round()
    xywh[0] = (10, 5, 80, 2 * H - 10)  # taller than the Pallas window
    xywh[1] = (W - 30, 2 * H - 20, 30, 20)  # bottom-right corner
    xywh[2] = (0, 0, 25, 12)
    xyxy = np.concatenate([xywh[:, :2], xywh[:, :2] + xywh[:, 2:]], -1).astype(np.float32)
    want_crops = np.asarray(_crop_batch_on_device(
        jnp.asarray(np.repeat(page[..., None], 3, -1)), jnp.asarray(xyxy),
        top.crop_h, top.crop_w))
    crops, _ = crop_resize(torch.from_numpy(page)[None], torch.zeros(n, dtype=torch.int32),
                           torch.from_numpy(xyxy), top.crop_h, top.crop_w)
    np.testing.assert_array_equal(crops[..., None].expand(*crops.shape, 3).numpy(),
                                  want_crops)

    futures = top.recognize_dispatch(torch.from_numpy(page), xywh, 1.0)
    assert [(k, t.shape[0]) for k, t, _ in futures] == [(32, 32), (8, 8)]
    got = top.recognize_collect(futures)
    want = jop.recognize_from_page(jnp.asarray(np.repeat(page[..., None], 3, -1)), xywh, 1.0)
    assert [w["text"] for w in got] == [w["text"] for w in want]
    np.testing.assert_allclose([w["confidence"] for w in got],
                               [w["confidence"] for w in want], rtol=0, atol=1e-5)
    assert top.recognize_dispatch(torch.from_numpy(page), np.zeros((0, 4)), 1.0) == []


def test_dispatch_streams_reuse_their_worker_threads(processors, monkeypatch):
    """Streams run on one kept thread (cuDNN's convolution plans are per
    thread): one stream after another reuses it, and two streams consumed
    in turns both run on it, a group at a time, without waiting for each
    other's consumer; a stream whose consumer stops reading is dropped
    and does not hold up the next."""
    import threading

    _, (tbp, top) = processors
    upload = tfused._upload_group
    seen = []

    def recording_upload(*a, **k):
        seen.append(threading.current_thread())
        return upload(*a, **k)

    monkeypatch.setattr(tfused, "_upload_group", recording_upload)
    pages = [_page(s) for s in range(2)]
    for _ in range(2):
        list(tfused.fused_dispatch_stream(tbp, top, pages, page_batch=1))
    assert len(seen) == 4 and len(set(seen)) == 1
    assert seen[0] is not threading.current_thread()
    device_thread = seen[0]
    seen.clear()
    a = tfused.fused_dispatch_stream(tbp, top, pages, page_batch=1, max_in_flight=1)
    b = tfused.fused_dispatch_stream(tbp, top, pages, page_batch=1, max_in_flight=1)
    got = [next(a), next(b), next(a), next(b)]
    assert [tfused.handle_page_count(h) for h in got] == [1, 1, 1, 1]
    assert list(a) == [] and list(b) == []
    assert set(seen) == {device_thread}
    three = [_page(s) for s in range(3)]
    left = tfused.fused_dispatch_stream(tbp, top, three, page_batch=1, max_in_flight=1)
    next(left)
    left.close()  # the consumer stops reading with groups left
    assert [tfused.handle_page_count(h) for h in tfused.fused_dispatch_stream(
        tbp, top, three, page_batch=1, max_in_flight=1)] == [1, 1, 1]


def test_concurrent_streams_share_the_device_thread(processors, monkeypatch):
    """Four threads each stream their own pages at once (max_in_flight
    1): every group runs on the one device thread, each stream's handles
    come back in its page order, and the engine's results equal the same
    calls made one after another."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    _, (tbp, top) = processors
    upload = tfused._upload_group
    seen = set()

    def recording_upload(*a, **k):
        seen.add(threading.current_thread())
        return upload(*a, **k)

    monkeypatch.setattr(tfused, "_upload_group", recording_upload)
    docs = [[_page(10 * i + s, n_words=4) for s in range(3)] for i in range(4)]
    engine = PipelineOcrEngine(tbp, top, page_fuse_batch=1, compact_slots=4)
    sequential = [engine.extract(d) for d in docs]
    with ThreadPoolExecutor(4) as pool:
        concurrent = list(pool.map(engine.extract, docs, timeout=300))
    assert concurrent == sequential and len(seen) == 1
    assert sum(len(r["words"]) for rs in sequential for r in rs) > 12
