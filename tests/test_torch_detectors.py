"""The port's other word detectors (ink, DiT, TextFuseNet), ROIAlign and
the engine's non-fused page paths, against the JAX package's on the same
numpy inputs and trees.

Limits, set from measurement on this CPU:

* equality: the ink closing against ``lax.reduce_window``, the ink
  detector's boxes (Otsu, the closing and the run-domain components are
  exact), the DiT and TextFuseNet boxes on the trained trees (after the
  host rounding of ``organize_boxes`` where the engine runs), every
  result dict of the engine's page-resident (ink) and host-fragment (DiT)
  paths, ``roi_align_single`` (the JAX float32 operations in XLA's
  rounding, fused multiply-adds included), the depth-to-space;
* one float32 ulp of the largest input: the x2 bilinear upsample at DiT's
  grid sizes (XLA's CPU contracts its second axis with or without a fused
  multiply-add depending on the shape; measured 4.8e-7 on N(0, 1) inputs);
* 4e-6: the batched ``roi_align`` (XLA fuses the vmapped JAX version
  otherwise; measured 3.0e-6 on unit-variance maps);
* DIT_LIMIT 2e-6 on heatmaps (measured 3.6e-7 at ``dit_synth_s1``), the
  default configuration's heatmap at 1024x768 the same; GRID_LIMIT 4e-6
  on the backbone's grid (LayerNorm outputs up to ~4; measured 2.1e-6);
* TFN_LIMIT 1e-4 on TextFuseNet's maps, scores and refined boxes in grid
  cells (measured 3.1e-5 on the trained tree's boxes, 1.5e-5 on ``seg``);
* the detector scores within 1e-5 (measured 1.3e-6).

Where a seeded model's heatmap is thresholded, the masks of the two sides
may differ only at pixels within DIT_LIMIT of the threshold, and boxes
are compared where the masks are equal.
"""

import importlib
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from marie_tpu_torch.boxes.box_processor import fit_page
from marie_tpu_torch.boxes.dit_box_processor import (
    DEFAULT_CONFIG,
    BoxProcessorUlimDit,
    DiTDetector,
    dit_heatmap,
)
from marie_tpu_torch.boxes.ink_box_processor import InkBoxProcessor, max_pool_same
from marie_tpu_torch.boxes.textfusenet_box_processor import BoxProcessorTextFuseNet, tfn_detect
from marie_tpu_torch.document.trocr_ocr_processor import TrOcrProcessor
from marie_tpu_torch.enums import PSMode
from marie_tpu_torch.models import configs as tcfg
from marie_tpu_torch.models.craft import depth_to_space, resize_bilinear
from marie_tpu_torch.models.textfusenet import TextFuseNet
from marie_tpu_torch.ocr.ocr_engine import PipelineOcrEngine
from marie_tpu_torch.ops.roi_align import roi_align, roi_align_rotated, roi_align_single
from marie_tpu_torch.preprocess.ops import normalize_page
from marie_tpu_torch.registry.convert import init_flax_layout, load_model
from marie_tpu_torch.registry.zoo import ZOO_DIR, open_zoo_json

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIT_LIMIT = 2e-6
GRID_LIMIT = 4e-6
TFN_LIMIT = 1e-4
SCORE_LIMIT = 1e-5
TINY_DIT = tcfg.ViTConfig(image_size=(64, 48), patch_size=16, hidden_dim=64, num_layers=2,
                          num_heads=2, mlp_dim=128, use_cls_token=False, head_stride=1,
                          subpixel=2)


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _jvit(cfg):
    from marie_tpu.models.configs import ViTConfig

    kw = {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}
    kw["image_size"] = tuple(kw["image_size"])
    return ViTConfig(**kw)


@pytest.fixture(scope="module")
def shipped():
    with np.load(os.path.join(ZOO_DIR, "pages.npz")) as data:
        return {k: data[k] for k in data.files}


def _rgb(page):
    return np.stack([page] * 3, axis=-1) if page.ndim == 2 else page


def _zoo_tree(name):
    """A trained tree of ``model_zoo/`` as numpy (skips where absent, as
    the JAX package's own tests do)."""
    if not os.path.isdir(os.path.join(REPO, "model_zoo", name)):
        pytest.skip(f"model_zoo/{name} is not present")
    from marie_tpu.registry.zoo import zoo_params

    return jax.device_get(zoo_params(name))


# --- ink ------------------------------------------------------------------

@pytest.mark.parametrize("window", [(1, 9), (1, 8), (3, 4), (2, 2)])
def test_ink_closing_matches_reduce_window(window):
    """Dilation and closing equal ``reduce_window(max, "SAME")`` with -inf
    padding, for odd and even windows (the border counts as ink for the
    erosion)."""
    wy, wx = window
    ink = np.random.default_rng(wx).random((40, 56)) < 0.3

    def jpool(m):
        return jax.lax.reduce_window(jnp.asarray(m, jnp.float32), -jnp.inf, jax.lax.max,
                                     (wy, wx), (1, 1), "SAME") > 0

    jdil = jpool(ink)
    want = np.asarray(~jpool(~jdil))
    dil = max_pool_same(torch.from_numpy(ink), wy, wx)
    np.testing.assert_array_equal(dil.numpy(), np.asarray(jdil))
    got = ~max_pool_same(~dil, wy, wx)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("page", ["0", "9", "oversize"])
def test_ink_boxes_match_jax(shipped, page):
    """``InkBoxProcessor`` boxes equal the JAX processor's on shipped pages
    and on the 3300x2550 page (scaled by ~0.31 into the largest bucket,
    not an integer factor)."""
    from marie_tpu.boxes.ink_box_processor import InkBoxProcessor as JaxInk

    img = _rgb(shipped["oversize"] if page == "oversize" else shipped["pages"][int(page)])
    want = JaxInk().detect_words(img)
    got = InkBoxProcessor(device="cpu").detect_words(img)
    assert len(want[0]) > 10
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


# --- the engine's non-fused paths ------------------------------------------

@pytest.fixture(scope="module")
def tiny_trocr():
    from marie_tpu.document.trocr_ocr_processor import TrOcrProcessor as JaxTrOcr
    from marie_tpu.models.configs import TrOCRConfig

    tree = init_flax_layout(tcfg.TrOCRConfig.tiny(), 8)
    return (JaxTrOcr(config=TrOCRConfig.tiny(), batch_sizes=(32, 128), params=_jtree(tree)),
            TrOcrProcessor(tcfg.TrOCRConfig.tiny(), tree, batch_sizes=(32, 128),
                           device="cpu"))


def _both_engines(jbp, tbp, tiny_trocr, pages, mode):
    from marie_tpu.enums import PSMode as JaxPSMode
    from marie_tpu.ocr.ocr_engine import PipelineOcrEngine as JaxEngine

    jop, top = tiny_trocr
    want = JaxEngine(jbp, jop).extract(pages, JaxPSMode(mode))
    got = PipelineOcrEngine(tbp, top).extract(pages, PSMode(mode))
    return got, want


def _assert_same_results(got, want):
    """Result dicts equal, confidences within 1e-3 (3-decimal rounding of
    float32 values that may differ in their last bit)."""
    def strip(results):
        return [dict(r, words=[dict(w, confidence=None) for w in r["words"]],
                     lines=[dict(ln, confidence=None) for ln in r["lines"]])
                for r in results]

    def confs(results):
        return [w["confidence"] for r in results for w in r["words"]]

    assert strip(got) == strip(want)
    np.testing.assert_allclose(confs(got), confs(want), rtol=0, atol=1e-3)


@pytest.mark.parametrize("mode", ["sparse", "line"])
def test_engine_page_resident_ink_matches_jax(shipped, tiny_trocr, mode):
    """A detector with ``detect_with_page`` and no ``detect_dispatch`` (ink):
    detect each page as RGB, recognise from the device page; the engine's
    results equal the JAX engine's on 2 shipped pages (SPARSE) and 1 (LINE)."""
    from marie_tpu.boxes.ink_box_processor import InkBoxProcessor as JaxInk

    tbp = InkBoxProcessor(device="cpu")
    assert not hasattr(tbp, "detect_dispatch")
    pages = [shipped["pages"][0], shipped["pages"][3]][:2 if mode == "sparse" else 1]
    got, want = _both_engines(JaxInk(), tbp, tiny_trocr, pages, mode)
    assert sum(len(r["words"]) for r in want) > 50 * len(pages)
    _assert_same_results(got, want)


def test_engine_fragments_dit_matches_jax(shipped, tiny_trocr):
    """A detector with only ``detect_words`` (DiT, trained tree): host
    fragments through ``extract_bounding_boxes``; the engine's results
    equal the JAX engine's on 2 shipped pages (it raised before)."""
    from marie_tpu.boxes.dit_box_processor import BoxProcessorUlimDit as JaxDit

    tree = _zoo_tree("dit-s1-synth")
    jbp = JaxDit(config=_jvit(tcfg.ViTConfig.dit_synth_s1()), variables=_jtree(tree))
    tbp = BoxProcessorUlimDit(config=tcfg.ViTConfig.dit_synth_s1(), variables=tree,
                              device="cpu")
    assert not hasattr(tbp, "detect_with_page")
    got, want = _both_engines(jbp, tbp, tiny_trocr, [shipped["pages"][1],
                                                     shipped["pages"][6]], "sparse")
    assert sum(len(r["words"]) for r in want) > 100
    _assert_same_results(got, want)


# --- DiT ---------------------------------------------------------------------

@pytest.mark.parametrize("cls_token", [False, True])
def test_feature_grid_matches_jax(cls_token):
    """The backbone's [B, H/16, W/16, D] grid (the CLS token dropped)."""
    import dataclasses

    from marie_tpu.models.vit import ViTEncoder as JaxViT
    from marie_tpu_torch.registry.convert import from_flax

    cfg = dataclasses.replace(TINY_DIT, use_cls_token=cls_token)
    tree = {"params": init_flax_layout(cfg, 4)["params"]["backbone"]}
    model = from_flax(tree, DiTDetector(cfg).backbone).eval()
    x = np.random.default_rng(2).random((2, 64, 48, 3)).astype(np.float32)
    want = JaxViT(_jvit(cfg)).apply(_jtree(tree), jnp.asarray(x), method="feature_grid")
    with torch.no_grad():
        got = model.feature_grid(torch.from_numpy(x))
    assert got.shape == (2, 4, 3, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=GRID_LIMIT)


@pytest.mark.parametrize("hwc", [(32, 24, 16), (64, 48, 16), (128, 96, 8)])
def test_upsample_matches_jax(hwc):
    """DiT's x2 bilinear upsample at its grid sizes (``dit_synth_s1``:
    32x24 -> 256x192; the default: 64x48 -> 256x192), within one ulp of
    the largest input."""
    h, w, c = hwc
    x = np.random.default_rng(h).standard_normal((1, h, w, c)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 2 * h, 2 * w, c), "bilinear"))
    got = resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), (2 * h, 2 * w))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0,
                               atol=float(np.spacing(np.abs(x).max())))


@pytest.mark.parametrize("r,nc", [(2, 2), (2, 1), (4, 3)])
def test_depth_to_space_matches_jax(r, nc):
    x = np.arange(2 * 3 * 5 * r * r * nc, dtype=np.float32).reshape(2, 3, 5, r * r * nc)
    want = x.reshape(2, 3, 5, r, r, nc).transpose(0, 1, 3, 2, 4, 5).reshape(
        2, 3 * r, 5 * r, nc)
    np.testing.assert_array_equal(depth_to_space(torch.from_numpy(x), r, nc).numpy(), want)


@pytest.mark.parametrize("cfg", [TINY_DIT, tcfg.ViTConfig.dit_synth_s1()],
                         ids=["tiny", "dit_synth_s1"])
def test_dit_detector_matches_jax(cfg):
    from marie_tpu.boxes.dit_box_processor import DiTDetector as JaxDiT

    tree = init_flax_layout(cfg, 3)
    x = np.random.default_rng(0).random((1, *cfg.image_size, 3)).astype(np.float32)
    want = np.asarray(jax.jit(JaxDiT(_jvit(cfg)).apply)(_jtree(tree), jnp.asarray(x)))
    with torch.no_grad():
        got = load_model(cfg, tree, "cpu")(torch.from_numpy(x)).numpy()
    assert got.shape == (1, cfg.image_size[0] // cfg.head_stride,
                         cfg.image_size[1] // cfg.head_stride, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=DIT_LIMIT)


def test_dit_trained_boxes_match_jax(shipped):
    """On ``model_zoo/dit-s1-synth``'s trained tree ``detect_words`` gives
    the JAX boxes on 2 shipped pages, and on the 3300x2550 page."""
    from marie_tpu.boxes.dit_box_processor import BoxProcessorUlimDit as JaxDit

    tree = _zoo_tree("dit-s1-synth")
    jbp = JaxDit(config=_jvit(tcfg.ViTConfig.dit_synth_s1()), variables=_jtree(tree))
    tbp = BoxProcessorUlimDit(config=tcfg.ViTConfig.dit_synth_s1(), variables=tree,
                              device="cpu")
    for img in (shipped["pages"][0], shipped["pages"][7], shipped["oversize"]):
        want = jbp.detect_words(_rgb(img))
        got = tbp.detect_words(_rgb(img))
        assert len(want[0]) > 10
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=SCORE_LIMIT)


def _thresholded_equal(got_heat, want_heat, thr, limit):
    """Masks at ``thr`` equal except at pixels within ``limit`` of it;
    returns whether they are equal."""
    gm, wm = got_heat > thr, want_heat > thr
    off = gm != wm
    assert (np.abs(want_heat[off] - thr) <= limit).all()
    return not off.any()


def test_dit_default_config_matches_jax(shipped):
    """The no-tree configuration (1024x768, 3,072 tokens, 384 wide) from
    the port's seeded tree: heatmap within DIT_LIMIT, and ``detect_words``
    at thresholds from the heatmap's 90th and 95th percentiles gives the
    JAX boxes where the masks agree."""
    from marie_tpu.boxes.dit_box_processor import BoxProcessorUlimDit as JaxDit

    tree = init_flax_layout(DEFAULT_CONFIG, 0)
    page = _rgb(shipped["pages"][2])
    tbp = BoxProcessorUlimDit(config=DEFAULT_CONFIG, variables=tree, device="cpu")
    heat = dit_heatmap(tbp.model, torch.from_numpy(page)).numpy()
    jbp = JaxDit(config=_jvit(DEFAULT_CONFIG), variables=_jtree(tree))
    from marie_tpu.preprocess.ops import normalize_page as jnorm

    want = np.asarray(jax.jit(jbp.model.apply)(jbp.variables, jnorm(jnp.asarray(page))[None])[0])
    np.testing.assert_allclose(heat, want, rtol=0, atol=DIT_LIMIT)
    low, text = (float(np.quantile(want[..., 0], q)) for q in (0.90, 0.95))
    for bp in (tbp, jbp):
        bp.low_text, bp.text_threshold = low, text
    if _thresholded_equal(heat[..., 0], want[..., 0], low, DIT_LIMIT):
        got, exp = tbp.detect_words(page), jbp.detect_words(page)
        assert len(exp[0]) > 0
        np.testing.assert_array_equal(got[0], exp[0])


# --- ROIAlign -----------------------------------------------------------------

def _rois(rng, n, hi):
    b = rng.uniform(-3.0, hi, (n, 2)).astype(np.float32)
    boxes = np.concatenate([b, b + rng.uniform(0.5, 20.0, (n, 2)).astype(np.float32)], 1)
    boxes[:8] = np.round(boxes[:8])  # samples on integer coordinates
    return boxes


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("scale,ratio", [(1.0, 2), (0.25, 2), (1.0, 3)])
def test_roi_align_single_matches_jax(aligned, scale, ratio):
    """Bit for bit, with boxes past the map (samples out of bounds), on
    integer coordinates, aligned or not."""
    jroi = importlib.import_module("marie_tpu.ops.roi_align")
    rng = np.random.default_rng(0)
    feat = rng.standard_normal((8, 30, 40)).astype(np.float32)
    boxes = _rois(rng, 48, 42.0 / scale)
    want = np.asarray(jroi.roi_align_single(jnp.asarray(feat), jnp.asarray(boxes), 7, scale,
                                            ratio, aligned))
    got = roi_align_single(torch.from_numpy(feat), torch.from_numpy(boxes), 7, scale, ratio,
                           aligned, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)


def test_roi_align_matches_jax():
    jroi = importlib.import_module("marie_tpu.ops.roi_align")
    rng = np.random.default_rng(1)
    feats = rng.standard_normal((3, 4, 20, 24)).astype(np.float32)
    rois = np.concatenate([rng.integers(0, 3, (24, 1)).astype(np.float32),
                           _rois(rng, 24, 22.0)], 1)
    want = np.asarray(jroi.roi_align(jnp.asarray(feats), jnp.asarray(rois), 5, 1.0, 2))
    got = roi_align(torch.from_numpy(feats), torch.from_numpy(rois), 5, 1.0, 2,
                    device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=4e-6)
    # ROADMAP item 5 is done: the rotated ROIAlign (cx, cy, w, h, angle)
    rot = np.concatenate([rois[:, :1], rng.uniform(0, 22, (24, 2)), rng.uniform(1, 12, (24, 2)),
                          rng.uniform(-90, 90, (24, 1))], 1).astype(np.float32)
    want = np.asarray(jroi.roi_align_rotated(jnp.asarray(feats), jnp.asarray(rot), 5, 1.0, 2))
    got = roi_align_rotated(feats, rot, 5, 1.0, 2, device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# --- TextFuseNet ------------------------------------------------------------

def test_textfusenet_dense_and_fuse_match_jax():
    """``dense`` and ``fuse`` at seeded ``synth_s2`` on a 256x192 page."""
    from marie_tpu.models.textfusenet import TextFuseNet as JaxTfn
    from marie_tpu.models.textfusenet import TextFuseNetConfig as JaxCfg

    cfg = tcfg.TextFuseNetConfig.synth_s2()
    tree = init_flax_layout(cfg, 5)
    jm, jv = JaxTfn(JaxCfg.synth_s2()), _jtree(tree)
    x = np.random.default_rng(0).random((1, 256, 192, 3)).astype(np.float32)
    want = jax.jit(jm.apply)(jv, jnp.asarray(x))
    model = load_model(cfg, tree, "cpu")
    assert isinstance(model, TextFuseNet)
    with torch.no_grad():
        got = model.dense(torch.from_numpy(x))
    for key in ("word", "char", "seg_logits", "seg_feat", "p3"):
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0,
                                   atol=TFN_LIMIT, err_msg=key)
    rng = np.random.default_rng(1)
    wb, cb = _rois(rng, cfg.max_words, 40.0), _rois(rng, cfg.max_chars, 40.0) * 0.3
    wv, cv = rng.random(cfg.max_words) < 0.8, rng.random(cfg.max_chars) < 0.8
    p3, seg = np.asarray(want["p3"][0]), np.asarray(want["seg_feat"][0])
    jscore, jref = jax.jit(lambda *a: jm.apply(jv, *a, method=JaxTfn.fuse))(
        p3, seg, wb, wv, cb, cv)
    with torch.no_grad():
        score, refined = model.fuse(*(torch.from_numpy(a) for a in (p3, seg, wb, wv, cb, cv)))
    np.testing.assert_allclose(score.numpy(), np.asarray(jscore), rtol=0, atol=TFN_LIMIT)
    np.testing.assert_allclose(refined.numpy(), np.asarray(jref), rtol=0, atol=TFN_LIMIT)


def test_textfusenet_trained_boxes_match_jax(shipped):
    """On ``model_zoo/textfusenet-s2-synth``'s trained tree: the word and
    char candidates (boxes, areas, valid, heat scores) equal JAX's, the
    fused scores and refined boxes are within TFN_LIMIT, and
    ``detect_words`` boxes agree to 4 * TFN_LIMIT pixels, on 2 pages."""
    from marie_tpu.boxes.textfusenet_box_processor import (
        BoxProcessorTextFuseNet as JaxTfnBp,
    )
    from marie_tpu.boxes.textfusenet_box_processor import _tfn_detect_jit
    from marie_tpu.models.textfusenet import TextFuseNetConfig as JaxCfg

    tree = _zoo_tree("textfusenet-s2-synth")
    jbp = JaxTfnBp(config=JaxCfg.synth_s2(), variables=_jtree(tree))
    tbp = BoxProcessorTextFuseNet(config=tcfg.TextFuseNetConfig.synth_s2(), variables=tree,
                                  device="cpu")
    for img in (shipped["pages"][0], shipped["pages"][7]):
        page = _rgb(img)
        want = jax.device_get(_tfn_detect_jit(jbp.model, jbp.variables, jnp.asarray(page),
                                              0.6, 0.6, 0.5))
        got = tfn_detect(tbp.model, torch.from_numpy(page), 0.6, 0.6, 0.5)
        for key in ("heat_boxes", "heat_scores", "areas", "valid", "char_boxes",
                    "char_valid"):
            np.testing.assert_array_equal(got[key].numpy(), want[key], err_msg=key)
        assert int(want["valid"].sum()) > 50
        for key in ("boxes", "scores", "seg"):
            np.testing.assert_allclose(got[key].numpy(), want[key], rtol=0, atol=TFN_LIMIT,
                                       err_msg=key)
        # detect_words' host filter on the stats just compared
        jb, tb = jbp.detect_words(page), tbp.detect_words(page)
        assert jb[0].shape == tb[0].shape
        np.testing.assert_allclose(tb[0], jb[0], rtol=0, atol=4 * TFN_LIMIT)
        np.testing.assert_allclose(tb[1], jb[1], rtol=0, atol=SCORE_LIMIT)


# --- chip_smoke.py's rules for the detectors phase ---------------------------

def _golden_first_page(name):
    import chip_smoke

    with open_zoo_json("golden_detectors") as f:
        g = json.load(f)[name]
    return chip_smoke, {**g, "pages": g["pages"][:1]}


def _moved(found, k, dx):
    boxes = np.array(found[0], np.float64)
    boxes[k, 0] += dx
    return boxes, found[1]


def test_dit_phase_rule_holds_the_cpu_and_fails_moved_boxes(shipped):
    """``chip_smoke.py``'s DiT rule on the port's CPU outputs at seeded
    ``dit_synth_s1`` (the golden's first page): they hold it; every box
    shifted by one pixel, or one box moved where no map pixel lies near a
    threshold, fails it, against the golden and against a reference whose
    masks agree; an engine word moved where the detector's boxes agree
    fails the engine rule."""
    cs, g = _golden_first_page("dit_s1")
    cfg = tcfg.ViTConfig.dit_synth_s1()
    bp = BoxProcessorUlimDit(config=cfg, variables=init_flax_layout(
        cfg, cs.DETECTOR_SEEDS["dit_s1"]), device="cpu", low_text=g["low_text"],
        text_threshold=g["text_threshold"], min_area=g["min_area"])
    page = _rgb(shipped["pages"][g["pages"][0]["page"]])
    found = bp.detect_words(page)
    heat = dit_heatmap(bp.model, fit_page(page, bp.buckets, "cpu")[0]).numpy()
    to_map = bp.buckets.fit_with_scale(*page.shape[:2])[1] / cfg.head_stride
    ok, rows = cs.dit_golden_rule("dit_s1", [found], [heat], g, to_map)
    assert ok and rows[0]["boxes"] > 100, rows

    shifted = (found[0] + np.array([1.0, 0, 0, 0]), found[1])
    ok, rows = cs.dit_golden_rule("dit_s1", [shifted], [heat], g, to_map)
    assert not ok and rows[0]["departures"] == 2 * len(found[0])
    tol = cs.CARD_CPU_GAP_LIMIT["dit_s1"] + cs.CPU_HEAT_LIMIT
    near = cs.threshold_pixels(heat[..., 0], [g["low_text"], g["text_threshold"]], tol=tol)
    far = next(k for k, b in enumerate(cs._xyxy(found[0])) if not cs._covers(b, near, to_map)
               and not cs._covers(b + [40, 0, 40, 0], near, to_map))
    ok, rows = cs.dit_golden_rule("dit_s1", [_moved(found, far, 40.0)], [heat], g, to_map)
    assert not ok and rows[0]["departures"] == 2 and rows[0]["unexplained"] == 2

    flips = cs.threshold_pixels(heat[..., 0], [g["low_text"]], ref=heat[..., 0])
    assert cs.detector_page_rule(found, found, flips, to_map, tol)["within_limits"]
    assert not cs.detector_page_rule(shifted, found, flips, to_map, tol)["within_limits"]
    assert not cs.detector_page_rule(_moved(found, far, 1.0), found, flips, to_map,
                                     tol)["within_limits"]
    # where every pixel crossed a threshold, one moved box is explained,
    # every box moved is past the cap
    anywhere = np.ones_like(flips)
    assert cs.detector_page_rule(_moved(found, far, 1.0), found, anywhere, to_map,
                                 tol)["within_limits"]
    assert not cs.detector_page_rule(shifted, found, anywhere, to_map, tol)["within_limits"]

    words = [{"words": [{"box": [int(v) for v in b], "text": "w"} for b in found[0]]}]
    assert cs._words_compare(words, words, [0])[0]
    moved = [{"words": [dict(wd) for wd in words[0]["words"]]}]
    moved[0]["words"][far]["box"] = [v + (1 if i == 0 else 0)
                                     for i, v in enumerate(moved[0]["words"][far]["box"])]
    assert not cs._words_compare(moved, words, [0])[0]
    # the detector's box moved too: 2 departures (one box on each side)
    assert cs._words_compare(moved, words, [2])[0]


def test_textfusenet_phase_rule_holds_the_cpu_and_fails_moved_boxes(shipped):
    """``chip_smoke.py``'s TextFuseNet rule on the port's CPU outputs at
    seeded ``synth_s2`` (the golden's first page): they hold it; every
    refined box shifted by one stride-4 cell, every word box by one
    pixel, or one word's heat box moved, fails it."""
    cs, g = _golden_first_page("textfusenet")
    cfg = tcfg.TextFuseNetConfig.synth_s2()
    bp = BoxProcessorTextFuseNet(config=cfg, variables=init_flax_layout(
        cfg, cs.DETECTOR_SEEDS["textfusenet"]), device="cpu", low_text=g["low_text"],
        word_threshold=g["word_threshold"], char_threshold=g["char_threshold"],
        fuse_threshold=g["fuse_threshold"], min_area=g["min_area"])
    page = _rgb(shipped["pages"][g["pages"][0]["page"]])
    found = bp.detect_words(page)
    dev_page = fit_page(page, bp.buckets, "cpu")[0]
    with torch.no_grad():
        dense = bp.model.dense(normalize_page(dev_page)[None])
    maps = {k: dense[k][0].numpy() for k in ("word", "char")}
    slots = cs._valid_slots({k: v.numpy() for k, v in tfn_detect(
        bp.model, dev_page, bp.word_threshold, bp.low_text, bp.char_threshold).items()})
    to_map = 4.0 / cfg.head_stride
    ok, rows = cs.tfn_golden_rule([found], [(maps, slots)], g, to_map)
    assert ok and rows[0]["slots"]["slots"] > 20, rows

    refined = {**slots, "refined": slots["refined"] + np.float32(1.0)}
    ok, rows = cs.tfn_golden_rule([found], [(maps, refined)], g, to_map)
    assert not ok and rows[0]["slots"]["changed_slots"] == len(slots["refined"])
    shifted = (found[0] + np.array([1.0, 0, 0, 0]), found[1])
    ok, rows = cs.tfn_golden_rule([shifted], [(maps, slots)], g, to_map)
    assert not ok and rows[0]["words"]["departures"] == 2 * len(found[0])
    heat = np.array(slots["heat_boxes"])
    heat[0] += np.float32(30.0)
    ok, rows = cs.tfn_golden_rule([found], [(maps, {**slots, "heat_boxes": heat})], g, to_map)
    assert not ok and rows[0]["slots"]["unexplained"] >= 1
