"""The port's per-page programs (``fused_page``, ``fused_pages``), its
``fused_dispatch`` and the ``"s"`` / ``"g"`` branches of
``fused_collect_many`` against the JAX package's ``_fused_page``,
``_fused_pages``, ``fused_dispatch`` and ``fused_collect_many``, on tiny
float32 models and 64x96 pages.

As in ``tests/test_torch_slice.py``: stats bit-exact, tokens identical,
confidences within 1e-5.  For ``box_source="heatmap"`` both sides are fed
the JAX CRAFT heatmap through a stand-in detector; ``"ink"`` runs each
side's own CRAFT (the mask depends on the page alone)."""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from marie_tpu.boxes.craft_box_processor import BoxProcessorCraft as JaxBoxProcessorCraft
from marie_tpu.document.trocr_ocr_processor import TrOcrProcessor as JaxTrOcrProcessor
from marie_tpu.enums import PSMode as JaxPSMode
from marie_tpu.models import configs as jcfg
from marie_tpu.models.craft import CRAFT as JaxCRAFT
from marie_tpu.models.trocr import TrOCRModel as JaxTrOCR
from marie_tpu.ocr import fused as jfused
from marie_tpu.preprocess import BucketSpec as JaxBucketSpec
from marie_tpu_torch.boxes.craft_box_processor import BoxProcessorCraft
from marie_tpu_torch.document.trocr_ocr_processor import TrOcrProcessor
from marie_tpu_torch.enums import PSMode
from marie_tpu_torch.models import configs as tcfg
from marie_tpu_torch.ocr import fused as tfused
from marie_tpu_torch.preprocess.buckets import BucketSpec
from marie_tpu_torch.registry.convert import init_flax_layout, load_model
from tests.test_torch_slice import _JaxFixedHeat, _TorchFixedHeat, _pages

H, W = 64, 96
CROP_H, CROP_W = 32, 64  # TrOCRConfig.tiny
STEPS = 8
CONF_ATOL = 1e-5


@pytest.fixture(scope="module")
def setup():
    craft_tree = init_flax_layout(tcfg.CraftConfig.tiny(), seed=7)
    trocr_tree = init_flax_layout(tcfg.TrOCRConfig.tiny(), seed=8)
    pages = _pages(19)
    rgb = jnp.asarray(np.repeat(pages[..., None], 3, -1).astype(np.float32) / 255.0)
    heat = np.array(JaxCRAFT(jcfg.CraftConfig.tiny()).apply(
        jax.tree_util.tree_map(jnp.asarray, craft_tree), rgb))
    region = heat[..., 0]
    return types.SimpleNamespace(
        craft_tree=craft_tree, trocr_tree=trocr_tree, pages=pages, heat=heat,
        low_text=float(np.quantile(region, 0.6)),
        text_threshold=float(np.quantile(region, 0.8)),
        trocr_t=load_model(tcfg.TrOCRConfig.tiny(), trocr_tree, device="cpu"),
        trocr_j=JaxTrOCR(jcfg.TrOCRConfig.tiny()),
        trocr_params=jax.tree_util.tree_map(jnp.asarray, trocr_tree),
    )


def _detectors(s, box_source, heat):
    """(JAX model, JAX variables, port model) for ``box_source``; the
    heatmap ones return ``heat``."""
    if box_source == "heatmap":
        return _JaxFixedHeat(), {"heat": jnp.asarray(heat)}, _TorchFixedHeat(heat)
    return (JaxCRAFT(jcfg.CraftConfig.tiny()),
            jax.tree_util.tree_map(jnp.asarray, s.craft_tree),
            load_model(tcfg.CraftConfig.tiny(), s.craft_tree, device="cpu"))


def _common(s, box_source, rec_slots):
    return (s.text_threshold, s.low_text, 0.4, 4.0, 0.14, 64, box_source, rec_slots,
            CROP_H, CROP_W)


def _assert_stats_equal(got, want):
    for field in ("boxes", "areas", "scores", "valid", "stride"):
        g, w = np.asarray(got[field]), np.asarray(want[field])
        assert g.dtype == w.dtype, field
        np.testing.assert_array_equal(g, w, err_msg=field)


@pytest.mark.parametrize("box_source,form,rec_slots", [
    ("heatmap", "gray", 16), ("heatmap", "gray", 3), ("ink", "gray", 16),
    ("ink", "rgb", 8)])
def test_fused_page_matches_jax(setup, box_source, form, rec_slots):
    """One page, grayscale [H, W] (crops from the channel-free view: K1's
    plain version here) or RGB with distinct channels (stock crops); every
    row decodes, kept or not."""
    s = setup
    page = s.pages[0]
    if form == "rgb":
        page = np.stack([page, page // 2 + 100, page], -1).astype(np.uint8)
    jmodel, jvars, tmodel = _detectors(s, box_source, s.heat[:1])
    clip = np.asarray([W - 3, H - 5], np.float32)
    want = jax.device_get(jfused._fused_page(
        jmodel, jvars, s.trocr_j, s.trocr_params, jnp.asarray(page), jnp.asarray(clip),
        *_common(s, box_source, rec_slots), jnp.float32, STEPS, False))
    got = tfused.fused_page(tmodel, s.trocr_t, torch.from_numpy(page),
                            torch.from_numpy(clip), *_common(s, box_source, rec_slots),
                            torch.float32, STEPS)
    _assert_stats_equal({k: v.numpy() for k, v in got[0].items()}, want[0])
    assert int(np.asarray(want[0]["valid"]).sum()) > 0
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=0, atol=CONF_ATOL)


@pytest.mark.parametrize("box_source,rec_slots", [("heatmap", 16), ("heatmap", 4),
                                                  ("ink", 12)])
def test_fused_pages_matches_jax(setup, box_source, rec_slots):
    """Two pages, ``rec_slots`` rows each; rows without a kept box start
    finished in the decode."""
    s = setup
    jmodel, jvars, tmodel = _detectors(s, box_source, s.heat)
    clip = np.asarray([[W, H], [W - 10, H - 2]], np.float32)
    want = jax.device_get(jfused._fused_pages(
        jmodel, jvars, s.trocr_j, s.trocr_params, jnp.asarray(s.pages), jnp.asarray(clip),
        *_common(s, box_source, rec_slots), jnp.float32, STEPS, False))
    got = tfused.fused_pages(tmodel, s.trocr_t, torch.from_numpy(s.pages),
                             torch.from_numpy(clip), *_common(s, box_source, rec_slots),
                             torch.float32, STEPS)
    _assert_stats_equal({k: v.numpy() for k, v in got[0].items()}, want[0])
    assert got[1].shape[:2] == (2, min(rec_slots, 64))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=0, atol=CONF_ATOL)


def _processors(s, box_source):
    """(JAX (bp, op), port (bp, op)) with the same tiny float32 weights;
    for ``"heatmap"`` both detectors return the JAX heatmap of the pages."""
    kw = dict(text_threshold=s.text_threshold, low_text=s.low_text, min_area=4,
              max_components=64, box_source=box_source)
    jbp = JaxBoxProcessorCraft(config=jcfg.CraftConfig.tiny(),
                               variables=jax.tree_util.tree_map(jnp.asarray, s.craft_tree),
                               bucket_spec=JaxBucketSpec(shapes=((H, W),)), **kw)
    tbp = BoxProcessorCraft(tcfg.CraftConfig.tiny(), s.craft_tree, device="cpu",
                            bucket_spec=BucketSpec(shapes=((H, W),)), **kw)
    jop = JaxTrOcrProcessor(config=jcfg.TrOCRConfig.tiny(), params=s.trocr_params,
                            decode_steps=STEPS)
    top = TrOcrProcessor(tcfg.TrOCRConfig.tiny(), s.trocr_tree, decode_steps=STEPS,
                         device="cpu")
    return (jbp, jop), (tbp, top)


def _assert_collected_equal(got, want):
    """fused_collect_many outputs equal: boxes, scores, lines, line boxes,
    word texts (confidences within CONF_ATOL)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g[:4], w[:4]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert [wd["text"] for wd in g[4]] == [wd["text"] for wd in w[4]]
        np.testing.assert_allclose([wd["confidence"] for wd in g[4]],
                                   [wd["confidence"] for wd in w[4]], rtol=0, atol=CONF_ATOL)
        assert g[5] is None and w[5] is None


@pytest.mark.parametrize("rec_slots", [64, 2])
def test_fused_dispatch_and_collect_match_jax(setup, rec_slots):
    """``fused_dispatch`` of a grayscale [H, W] page and a channel-equal
    RGB page, collected as ``"s"`` handles in one call; with 2 rows a page
    the kept boxes past them go through the overflow recogniser."""
    s = setup
    (jbp, jop), (tbp, top) = _processors(s, "ink")
    frames = [s.pages[0], np.repeat(s.pages[1][..., None], 3, -1)]
    modes = ["sparse", "line"]
    jh = [jfused.fused_dispatch(jbp, jop, f, rec_slots=rec_slots) for f in frames]
    want = jfused.fused_collect_many(jbp, jop, jh, [JaxPSMode(m) for m in modes])
    th = [tfused.fused_dispatch(tbp, top, f, rec_slots=rec_slots) for f in frames]
    assert [h.kind for h in th] == ["s", "s"] and th[1].pages.ndim == 2
    got = tfused.fused_collect_many(tbp, top, th, [PSMode(m) for m in modes])
    _assert_collected_equal(got, want)
    assert max(len(p[4]) for p in got) > 2  # with 2 rows, the overflow path ran
    assert all(tfused.handle_page_count(h) == 1 for h in th)


def test_g_handle_collect_matches_jax(setup):
    """A ``"g"`` handle (two pages of ``fused_pages``, 2 rows each, the
    rest overflowing) collected beside an ``"s"`` handle equals the JAX
    collect of the same handles."""
    s = setup
    (jbp, jop), (tbp, top) = _processors(s, "ink")
    preps_j = [jbp.prep_page(p) for p in s.pages]
    preps_t = [tbp.prep_page(p) for p in s.pages]
    clip = np.asarray([[w * sc, h * sc] for _, sc, (h, w) in preps_t], np.float32)
    rec_slots = 2
    stack = np.stack([p[0][..., 0] if p[0].ndim == 3 else p[0] for p in preps_t])
    jstats, jtok, jconf = jfused._fused_pages(
        jbp.model, jbp.variables, jop.model, jop.params, jnp.asarray(stack),
        jnp.asarray(clip), jbp.text_threshold, jbp.low_text, jbp.link_threshold,
        float(jbp.min_area), float(jbp.box_expand), jbp.max_components, jbp.box_source,
        rec_slots, jop.crop_h, jop.crop_w, jop.compute_dtype, jop.decode_steps, False)
    metas_j = [(p[1], p[2]) for p in preps_j]
    jpages = jnp.asarray(stack)
    jg = ("g", jstats, jtok, jconf, jpages, metas_j, rec_slots)
    js = jfused.fused_dispatch(jbp, jop, s.pages[0], rec_slots=rec_slots)
    modes = [JaxPSMode.SPARSE] * 3
    want = jfused.fused_collect_many(jbp, jop, [jg, js], modes)

    tpages = torch.from_numpy(stack)
    stats, tok, conf = tfused.fused_pages(
        tbp.model, top.model, tpages, torch.from_numpy(clip),
        *tfused.program_args(tbp, top, rec_slots), **tfused.cc_kwargs(tbp))
    tg = tfused._page_handle("g", tbp.device, stats, tok, conf, tpages,
                             [(p[1], p[2]) for p in preps_t], rec_slots)
    ts = tfused.fused_dispatch(tbp, top, s.pages[0], rec_slots=rec_slots)
    got = tfused.fused_collect_many(tbp, top, [tg, ts], [PSMode.SPARSE] * 3)
    _assert_collected_equal(got, want)
    assert tfused.handle_page_count(tg) == 2
    assert max(len(p[4]) for p in got[:2]) > rec_slots  # the overflow path ran
