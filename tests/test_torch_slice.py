"""The port's page program (``fused_pages_compact``) against the JAX
package's ``_fused_pages_compact``, and the port's engine against the
JAX engine, on two tiny pages.

For ``box_source="heatmap"`` the JAX CRAFT heatmap is fed to both
post-processing halves (a stand-in detector returns it), so stats must be
bit-exact and tokens identical; the ``"ink"`` mask depends on the page
alone, so there both sides run their own CRAFT."""

import types

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp

from marie_tpu.boxes.craft_box_processor import BoxProcessorCraft as JaxBoxProcessorCraft
from marie_tpu.document.trocr_ocr_processor import TrOcrProcessor as JaxTrOcrProcessor
from marie_tpu.models import configs as jcfg
from marie_tpu.models.craft import CRAFT as JaxCRAFT
from marie_tpu.models.tokenizer import CharTokenizer as JaxTokenizer
from marie_tpu.models.trocr import TrOCRModel as JaxTrOCR
from marie_tpu.ocr.fused import _fused_pages_compact, _kept_count
from marie_tpu.ocr.ocr_engine import PipelineOcrEngine as JaxEngine
from marie_tpu.preprocess import BucketSpec as JaxBucketSpec
from marie_tpu_torch.boxes.craft_box_processor import BoxProcessorCraft
from marie_tpu_torch.document.trocr_ocr_processor import TrOcrProcessor
from marie_tpu_torch.models import configs as tcfg
from marie_tpu_torch.ocr.fused import fused_pages_compact
from marie_tpu_torch.ocr.ocr_engine import PipelineOcrEngine
from marie_tpu_torch.preprocess.buckets import BucketSpec
from marie_tpu_torch.registry.convert import init_flax_layout, load_model

H, W = 64, 96
CROP_H, CROP_W = 32, 64  # TrOCRConfig.tiny
STEPS = 8


class _JaxFixedHeat:
    """Stand-in CRAFT for the JAX program: returns the heatmap it is given
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


def _pages(seed, n=2):
    rng = np.random.default_rng(seed)
    pages = np.full((n, H, W), 255, np.uint8)
    for p in pages:
        for _ in range(7):
            y, x = rng.integers(2, H - 12), rng.integers(2, W - 26)
            p[y:y + rng.integers(6, 10), x:x + rng.integers(8, 24)] = rng.integers(0, 90)
    return pages


@pytest.fixture(scope="module")
def setup():
    craft_tree = init_flax_layout(tcfg.CraftConfig.tiny(), seed=7)
    trocr_tree = init_flax_layout(tcfg.TrOCRConfig.tiny(), seed=8)
    pages = _pages(9)
    rgb = jnp.asarray(np.repeat(pages[..., None], 3, -1).astype(np.float32) / 255.0)
    heat = np.array(JaxCRAFT(jcfg.CraftConfig.tiny()).apply(
        jax.tree_util.tree_map(jnp.asarray, craft_tree), rgb))
    region = heat[..., 0]
    # thresholds at quantiles of this heatmap, so the mask forms components
    low_text = float(np.quantile(region, 0.6))
    text_threshold = float(np.quantile(region, 0.8))
    return types.SimpleNamespace(
        craft_tree=craft_tree, trocr_tree=trocr_tree, pages=pages, heat=heat,
        low_text=low_text, text_threshold=text_threshold,
        trocr_t=load_model(tcfg.TrOCRConfig.tiny(), trocr_tree, device="cpu"),
        trocr_j=JaxTrOCR(jcfg.TrOCRConfig.tiny()),
        trocr_params=jax.tree_util.tree_map(jnp.asarray, trocr_tree),
    )


def _pack4(pages):
    """uint8 pages -> (nibble-quantized pages, their u4 upload: high
    nibble first, as ``marie_tpu.utils.pack4.pack4`` packs)."""
    nib = (pages.astype(np.int32) + 8) // 17
    packed = ((nib[..., 0::2] << 4) | nib[..., 1::2]).astype(np.uint8)
    return (nib * 17).astype(np.uint8), packed


def _run_both(s, box_source, n_real, total_slots, min_area=4.0, box_expand=0.14,
              packed=0):
    clip = np.tile(np.asarray([[W, H]], np.float32), (2, 1))
    pages = _pack4(s.pages)[1] if packed else s.pages
    common = (s.text_threshold, s.low_text, 0.4, min_area, box_expand, 64,
              box_source, total_slots, CROP_H, CROP_W)
    if box_source == "heatmap":
        jmodel, jvars = _JaxFixedHeat(), {"heat": jnp.asarray(s.heat)}
        tmodel = _TorchFixedHeat(s.heat)
    else:
        jmodel = JaxCRAFT(jcfg.CraftConfig.tiny())
        jvars = jax.tree_util.tree_map(jnp.asarray, s.craft_tree)
        tmodel = load_model(tcfg.CraftConfig.tiny(), s.craft_tree, device="cpu")
    want = _fused_pages_compact(
        jmodel, jvars, s.trocr_j, s.trocr_params, jnp.asarray(pages),
        jnp.asarray(clip), jnp.int32(n_real), *common, jnp.float32, STEPS,
        False, packed)
    got = fused_pages_compact(
        tmodel, s.trocr_t, torch.from_numpy(pages), torch.from_numpy(clip),
        n_real, *common, torch.float32, STEPS, packed=packed)
    return got, jax.device_get(want)


@pytest.mark.parametrize("box_source,n_real,total_slots,packed",
                         [("heatmap", 2, 16, 0), ("heatmap", 1, 6, 0),
                          ("ink", 2, 12, 0), ("ink", 2, 12, 4)])
def test_fused_pages_compact_matches_jax(setup, box_source, n_real, total_slots,
                                         packed):
    """Stats bit-exact, tokens identical; the last case uploads the pages
    packed to 4 bits and unpacks them inside the program."""
    (stats, tokens, conf), (jstats, jtokens, jconf) = _run_both(
        setup, box_source, n_real, total_slots, packed=packed)
    for field in ("boxes", "areas", "scores", "valid", "stride"):
        g, w = stats[field].numpy(), np.asarray(jstats[field])
        assert g.dtype == w.dtype, field
        np.testing.assert_array_equal(g, w, err_msg=field)
    kept = int(np.asarray(jstats["valid"]).sum())
    assert kept > 0
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jtokens))
    np.testing.assert_allclose(conf.numpy(), np.asarray(jconf), atol=1e-5)


def test_heatmap_to_words_end_to_end(setup):
    """Engine results from a given heatmap equal the JAX engine's (result
    dicts; confidences within 1e-3, the schema's 3-decimal rounding).  The
    budget is 12 rows for the 2-page group, so the kept rows past it go
    through the processor's overflow dispatch on both sides; the rows
    within it also equal the JAX program's decoded rows."""
    s = setup
    kw = dict(text_threshold=s.text_threshold, low_text=s.low_text, min_area=4,
              max_components=64, box_source="heatmap")
    bp = BoxProcessorCraft(tcfg.CraftConfig.tiny(), s.craft_tree, device="cpu",
                           bucket_spec=BucketSpec(shapes=((H, W),)), **kw)
    bp.model = _TorchFixedHeat(s.heat)
    op = TrOcrProcessor(tcfg.TrOCRConfig.tiny(), s.trocr_tree, decode_steps=STEPS,
                        device="cpu")
    got = PipelineOcrEngine(bp, op, page_fuse_batch=2, compact_slots=6).extract(
        list(s.pages))
    jbp = JaxBoxProcessorCraft(config=jcfg.CraftConfig.tiny(), variables={"heat": s.heat},
                               bucket_spec=JaxBucketSpec(shapes=((H, W),)), **kw)
    jbp.model = _JaxFixedHeat()
    jop = JaxTrOcrProcessor(config=jcfg.TrOCRConfig.tiny(), params=s.trocr_params,
                            decode_steps=STEPS)
    want = JaxEngine(jbp, jop, page_fuse_batch=2, compact_slots=6).extract(list(s.pages))
    assert len(got) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose([wd.pop("confidence") for wd in g["words"]],
                                   [wd.pop("confidence") for wd in w["words"]], atol=1e-3)
        np.testing.assert_allclose([ln.pop("confidence") for ln in g["lines"]],
                                   [ln.pop("confidence") for ln in w["lines"]], atol=1e-3)
        assert g == w and len(g["words"]) > 0

    (_, _, _), (jstats, jtokens, _) = _run_both(s, "heatmap", 2, 128)
    texts = JaxTokenizer().decode_batch(np.asarray(jtokens))
    offset = overflow = 0
    for p in range(2):
        stats_p = {k: np.asarray(v)[p] for k, v in jstats.items()}
        xywh, _, rows = jbp.detect_collect((None, None, 1.0, (H, W)), stats=stats_p,
                                           return_rows=True)
        boxes_int, _, _, _, order = jbp.organize_boxes(xywh, np.zeros(len(xywh)), (H, W),
                                                       return_order=True)
        by_box = {tuple(wd["box"]): wd["text"] for wd in got[p]["words"]}
        for j, r in enumerate(np.asarray(rows)[order]):
            if offset + r < 12:
                assert by_box[tuple(boxes_int[j].tolist())] == texts[offset + r]
        overflow += sum(offset + r >= 12 for r in rows)
        offset += _kept_count(jbp, stats_p)
    assert 0 < overflow < offset  # both the budget and the overflow path ran


def test_engine_page_forms_and_buckets(setup):
    """Grayscale [H, W], channel-identical RGB and a page smaller than
    its bucket give the same words as the padded grayscale page; a page
    over the largest bucket gives the words of its downscaled copy at
    page coordinates, and an RGB page with distinct channels is taken as
    RGB, both as the JAX engine gives them."""
    s = setup
    bp = BoxProcessorCraft(tcfg.CraftConfig.tiny(), s.craft_tree, min_area=4,
                           max_components=64, box_source="ink", device="cpu",
                           bucket_spec=BucketSpec(shapes=((H, W), (2 * H, 2 * W))))
    op = TrOcrProcessor(tcfg.TrOCRConfig.tiny(), s.trocr_tree, decode_steps=STEPS,
                        device="cpu")
    engine = PipelineOcrEngine(bp, op, compact_slots=8)
    page = s.pages[0]
    small = page[: H - 8, : W - 16]
    want = engine.extract([page])
    rgb = engine.extract(np.repeat(page[..., None], 3, -1))
    assert rgb == want and len(want[0]["words"]) > 0
    mixed = engine.extract([small, np.pad(page, ((0, H), (0, W)), constant_values=255),
                            page])
    assert mixed[2]["words"] == want[0]["words"] and mixed[2]["lines"] == want[0]["lines"]
    for wd in mixed[0]["words"]:
        x, y, w, h = wd["box"]
        assert x + w <= W - 16 and y + h <= H - 8  # clipped to the real page
    big = np.repeat(np.repeat(page, 2, axis=0), 2, axis=1)  # 2H x 2W: fits
    tall = np.pad(big, ((0, 2 * H), (0, 0)), constant_values=255)  # 4H x 2W: halved
    jbp = JaxBoxProcessorCraft(
        config=jcfg.CraftConfig.tiny(), min_area=4, max_components=64, box_source="ink",
        variables=jax.tree_util.tree_map(jnp.asarray, s.craft_tree),
        bucket_spec=JaxBucketSpec(shapes=((H, W), (2 * H, 2 * W))))
    jop = JaxTrOcrProcessor(config=jcfg.TrOCRConfig.tiny(), params=s.trocr_params,
                            decode_steps=STEPS)
    color = np.repeat(page[..., None], 3, -1)
    color[0, 0] = (1, 2, 3)
    got = engine.extract([tall, color])
    want = JaxEngine(jbp, jop, compact_slots=8).extract([tall, color])
    assert [[(wd["text"], wd["box"]) for wd in r["words"]] for r in got] == [
        [(wd["text"], wd["box"]) for wd in r["words"]] for r in want]
    assert len(got[0]["words"]) > 0 and all(
        wd["box"][1] + wd["box"][3] <= 2 * H for wd in got[0]["words"])
