"""The port's template matchers (``marie_tpu_torch/components/
template_matching/``) against the JAX package's, on the CPU, on the same
numpy pages, templates and flax-layout trees.

Pages are shipped pages cut to 256x320; templates are word crops of one
page (by its truth boxes) and a noise patch found on no page.  Matches
(frame, label, bbox) are equal and scores within SCORE_LIMIT (measured:
NCC 1.1e-5, the port's map being float64; DIM 3.6e-7;
VQNNF 0: exact hit counts over the same codebook).  On near-white windows
of a warped page the JAX NCC's float32 statistics are noise and the
port's are not (``test_ncc_resolves_near_white_windows``).  Both trunks run:
``CraftConfig.base()`` seeded, and the trained ``craft-synth`` (skipped
where the JAX zoo lacks it, as the JAX tests skip).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from marie_tpu.components import template_matching as J
from marie_tpu.models.configs import CraftConfig as JaxCraftConfig
from marie_tpu.registry.zoo import zoo_checkpoint
from marie_tpu_torch.components import template_matching as T
from marie_tpu_torch.models.configs import CraftConfig
from marie_tpu_torch.registry.convert import init_flax_layout
from marie_tpu_torch.registry.zoo import ZOO_DIR

SCORE_LIMIT = 1e-4
NEAR_WHITE_LIMIT = 1e-6
TRAINED = zoo_checkpoint("craft-synth") is not None


def _shipped(idx, h=256, w=320):
    with np.load(os.path.join(ZOO_DIR, "pages.npz")) as data:
        pages = [np.ascontiguousarray(data["pages"][i]) for i in range(16)]
    with open(os.path.join(ZOO_DIR, "truth.json")) as f:
        truth = json.load(f)["pages"]
    tpls = [(f"word{k}", pages[0][y:y + bh, x:x + bw])
            for k, (_, (x, y, bw, bh)) in enumerate(truth[0][:3])]
    tpls.append(("noise", (np.random.default_rng(3).random((20, 40)) * 255).astype(np.uint8)))
    return [pages[i][:h, :w] for i in idx], tpls


def _keys(results):
    return [(m.frame_index, m.label, m.bbox) for m in results]


def _same(got, want, ordered=True):
    if not ordered:
        # matches whose scores tie within the limit may come in either order
        got, want = (sorted(r, key=lambda m: (m.frame_index, m.label, m.bbox))
                     for r in (got, want))
    assert _keys(got) == _keys(want)
    for g, w in zip(got, want):
        assert abs(g.score - w.score) <= SCORE_LIMIT
        assert abs(g.similarity - w.similarity) <= SCORE_LIMIT


def _pair(name, tree=None):
    kwargs = {}
    if name != "NCCTemplateMatcher":
        tree = tree if tree is not None else init_flax_layout(CraftConfig.base(), 0)
        jt = jax.tree_util.tree_map(jnp.asarray, tree)
        return (getattr(T, name)(variables=tree, config=CraftConfig.base(), device="cpu"),
                getattr(J, name)(variables=jt, config=JaxCraftConfig.base()))
    return getattr(T, name)(device="cpu", **kwargs), getattr(J, name)(**kwargs)


@pytest.mark.parametrize("name,threshold", [("NCCTemplateMatcher", 0.8),
                                            ("NCCTemplateMatcher", 0.5),
                                            ("DIMTemplateMatcher", 0.3),
                                            ("VQNNFTemplateMatcher", 0.3)])
def test_matcher_matches_jax(name, threshold):
    frames, tpls = _shipped([0, 1, 2])
    port, ref = _pair(name)
    for label, img in tpls:
        port.add_template(label, img)
        ref.add_template(label, img)
    got = port.match(frames, score_threshold=threshold)
    want = ref.match(frames, score_threshold=threshold)
    assert got, "no match: the comparison holds nothing"
    _same(got, want)


def _trained_tree():
    from marie_tpu.registry.zoo import zoo_params

    return jax.tree_util.tree_map(np.asarray, jax.device_get(zoo_params("craft-synth")))


@pytest.mark.skipif(not TRAINED, reason="craft trunk not trained")
@pytest.mark.parametrize("name", ["DIMTemplateMatcher", "VQNNFTemplateMatcher"])
def test_trained_trunk_matcher_matches_jax(name):
    frames, tpls = _shipped([0], h=192, w=256)
    port, ref = _pair(name, _trained_tree())
    for label, img in tpls[:2]:
        port.add_template(label, img)
        ref.add_template(label, img)
    got, want = port.match(frames, score_threshold=0.4), ref.match(frames, score_threshold=0.4)
    assert got
    _same(got, want)


def test_trunk_features_match_jax():
    from marie_tpu.components.template_matching.dim_matcher import _trunk_features
    from marie_tpu.models.craft import CRAFT as JaxCRAFT
    from marie_tpu_torch.components.template_matching.dim_matcher import trunk_features
    from marie_tpu_torch.registry.convert import load_model

    tree = init_flax_layout(CraftConfig.base(), 1)
    page = np.stack([_shipped([3], h=64, w=96)[0][0]] * 3, -1)
    want = np.asarray(_trunk_features(JaxCRAFT(JaxCraftConfig.base()),
                                      jax.tree_util.tree_map(jnp.asarray, tree),
                                      jnp.asarray(page)))
    model = load_model(CraftConfig.base(), tree, "cpu")
    with torch.no_grad():
        got = trunk_features(model, torch.from_numpy(page)).numpy()
    assert got.shape == want.shape == (16, 24, 256)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_vq_top_peaks_break_ties_as_jax():
    """Hit counts tie; the peaks come in ``jax.lax.top_k`` order."""
    from marie_tpu.components.template_matching.dim_matcher import _vq_match_jit
    from marie_tpu_torch.components.template_matching.base import top_peaks
    from marie_tpu_torch.components.template_matching.dim_matcher import vq_map

    rng = np.random.default_rng(0)
    page = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (20, 24))]
    tpl = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (3, 4))]
    want = jax.device_get(_vq_match_jit(jnp.asarray(page), jnp.asarray(tpl), 3, 4, 32))
    got = top_peaks(vq_map(torch.from_numpy(page), torch.from_numpy(tpl)), 3, 4, 32)
    assert len(set(want[1].tolist())) < 32  # the comparison holds ties
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_composite_matches_jax():
    frames, tpls = _shipped([0, 1])
    tree = init_flax_layout(CraftConfig.base(), 0)
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    port = T.CompositeTemplateMatcher([
        T.NCCTemplateMatcher(device="cpu"),
        T.DIMTemplateMatcher(variables=tree, config=CraftConfig.base(), device="cpu")])
    ref = J.CompositeTemplateMatcher([
        J.NCCTemplateMatcher(), J.DIMTemplateMatcher(variables=jt, config=JaxCraftConfig.base())])
    for label, img in tpls:
        port.add_template(label, img)
        ref.add_template(label, img)
    got, want = port.match(frames, score_threshold=0.4), ref.match(frames, score_threshold=0.4)
    assert got
    _same(got, want, ordered=False)


def test_ocr_conditioned_matching_matches_jax():
    frames, tpls = _shipped([0])
    port = T.OcrConditionedMatcher(T.NCCTemplateMatcher(device="cpu"), text_threshold=0.6)
    ref = J.OcrConditionedMatcher(J.NCCTemplateMatcher(), text_threshold=0.6)
    with open(os.path.join(ZOO_DIR, "truth.json")) as f:
        truth = json.load(f)["pages"][0]
    for k, (label, img) in enumerate(tpls):
        text = truth[k][0] if k < 2 else None  # two anchored, two visual
        port.add_template(label, img, text)
        ref.add_template(label, img, text)
    words = [{"text": t, "box": b} for t, b in truth]
    for ocr in ([{"words": words}], [{"words": words[2:]}]):
        got = port.match_with_ocr(frames, ocr, score_threshold=0.8)
        want = ref.match_with_ocr(frames, ocr, score_threshold=0.8)
        _same(got, want)
    assert len(port.match(frames, score_threshold=0.8)) > len(got)  # the anchors rejected some


def test_ncc_matcher_no_false_positive_on_blank():
    page = np.full((200, 200, 3), 255, np.uint8)
    tpl = (np.random.default_rng(1).random((16, 16, 3)) * 255).astype(np.uint8)
    port = T.NCCTemplateMatcher(device="cpu")
    port.add_template("x", tpl)
    assert port.match([page], score_threshold=0.8) == []


def test_load_definitions_reads_png_and_tiff(tmp_path):
    from PIL import Image

    from marie_tpu_torch.utils.image_io import write_png, write_tiff

    rng = np.random.default_rng(2)
    gray = rng.integers(0, 256, (12, 20), dtype=np.uint8)
    rgb = rng.integers(0, 256, (10, 14, 3), dtype=np.uint8)
    write_png(str(tmp_path / "a.png"), gray)
    write_tiff(str(tmp_path / "b.tif"), [rgb])
    Image.fromarray(rgb).save(tmp_path / "c.jpg")
    defs = [{"label": "a", "template": str(tmp_path / "a.png"), "text": "x"},
            {"label": "b", "template": str(tmp_path / "b.tif")},
            {"label": "c", "template": rgb}]
    port, ref = T.NCCTemplateMatcher(device="cpu"), J.NCCTemplateMatcher()
    port.load_definitions(defs)
    ref.load_definitions(defs)
    for p, r in zip(port._templates, ref._templates):
        assert (p["label"], p["text"]) == (r["label"], r["text"])
        np.testing.assert_array_equal(p["image"], r["image"])
    with pytest.raises(ValueError, match="PNG and TIFF"):
        port.load_definitions([{"label": "c", "template": str(tmp_path / "c.jpg")}])


def test_matchers_default_to_the_card():
    import inspect

    for cls in (T.NCCTemplateMatcher, T.DIMTemplateMatcher):
        assert inspect.signature(cls).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            T.NCCTemplateMatcher()
    m = T.DIMTemplateMatcher(device="cpu")
    assert not m.trained and m.config == CraftConfig.base()  # the port's zoo has no trunk


def test_ncc_resolves_near_white_windows():
    """On a registered page the paper is 255 and 254 (the warp's
    truncation).  The JAX matcher's float32 window variance is rounding
    noise there and its map passes 1 (scores of 4 measured); the port's
    map, taken in float64, is a float64 reference's within
    NEAR_WHITE_LIMIT everywhere, and 1 on the template's own window."""
    import torch.nn.functional as F

    from marie_tpu.components.template_matching.ncc_matcher import _ncc_jit
    from marie_tpu_torch.components.document_registration import (
        DocumentBoundaryRegistration,
    )
    from marie_tpu_torch.components.document_registration.boundary import rotate_page
    from marie_tpu_torch.components.template_matching.ncc_matcher import _gray01, ncc_map

    page = np.stack([_shipped([0])[0][0]] * 3, -1)
    skewed = rotate_page(torch.from_numpy(page), np.float32(np.radians(2.2))).numpy()
    gray = _gray01(DocumentBoundaryRegistration(use_model=False, device="cpu")
                   .register(skewed).aligned)
    tpl = gray[40:64, 40:100]
    got = ncc_map(torch.from_numpy(gray), torch.from_numpy(tpl)).numpy()
    g, t = torch.from_numpy(gray).double(), torch.from_numpy(tpl).double()
    tz = t - t.mean()
    ones = torch.ones((1, 1, *tpl.shape), dtype=torch.float64)
    s1, s2 = (F.conv2d(x[None, None], ones)[0, 0] for x in (g, g * g))
    var = torch.clamp(s2 - s1 * s1 / tpl.size, min=1e-6)
    ref = (F.conv2d(g[None, None], tz[None, None])[0, 0]
           / (torch.sqrt(var) * torch.sqrt((tz * tz).sum() + 1e-6))).numpy()
    assert np.abs(got - ref).max() <= NEAR_WHITE_LIMIT
    _, jax_scores, _ = jax.device_get(_ncc_jit(jnp.asarray(gray), jnp.asarray(tpl), 24, 60, 32))
    assert jax_scores.max() > 1.5  # the float32 window statistics' noise
    assert abs(got[40, 40] - 1.0) <= SCORE_LIMIT


def _golden_rows(name):
    with open(os.path.join(ZOO_DIR, "golden_register.json")) as f:
        return json.load(f)["matching"][name]


def _smoke_pages():
    with np.load(os.path.join(ZOO_DIR, "pages.npz")) as data:
        return list(data["pages"])


def test_smoke_golden_check_fails_shifted_boxes():
    """``chip_smoke.py``'s comparison with the golden: the golden's own rows
    pass; every box one cell off fails, though every score is the same
    (on the seeded trunk every DIM match is a blank window: the word
    templates' rows are unexplained, the noise template's swaps too many)."""
    import chip_smoke

    pages, want = _smoke_pages(), _golden_rows("dim")
    same = chip_smoke._matches_off(want, want, 0.6, pages, 15, 16)
    assert same["within_limits"] and same["tie_swaps"] == same["threshold_flips"] == 0
    shifted = [[f, lbl, [x + 4, y, w, h], sc] for f, lbl, (x, y, w, h), sc in want]
    off = chip_smoke._matches_off(shifted, want, 0.6, pages, 15, 16)
    assert not off["within_limits"] and off["tie_swaps"] > 15
    assert {u[2] for u in off["unexplained"]} == {r[1] for r in want} - {"noise"}


def test_smoke_golden_check_pairs_swaps_in_a_uniform_strip():
    """A noise-template row moved along the white bottom strip is a tie
    swap, allowed up to its limit; a word-template row moved off its word,
    or a noise row moved out of the strip, is not."""
    import chip_smoke

    pages, want = _smoke_pages(), _golden_rows("dim")
    k = next(i for i, (f, lbl, b, _) in enumerate(want) if lbl == "noise" and b[1] == 992
             and not any(r[0] == f and r[1] == lbl and r[2][1] == 992 and r[2][0] == 216
                         for r in want))
    moved = [list(r) for r in want]
    moved[k] = [want[k][0], "noise", [216, 992, 64, 32], want[k][3]]
    assert chip_smoke._matches_off(moved, want, 0.6, pages, 1)["tie_swaps"] == 1
    assert chip_smoke._matches_off(moved, want, 0.6, pages, 1)["within_limits"]
    assert not chip_smoke._matches_off(moved, want, 0.6, pages, 0)["within_limits"]
    out_of_strip = [list(r) for r in want]
    out_of_strip[k] = [want[k][0], "noise", [216, 900, 64, 32], want[k][3]]
    assert not chip_smoke._matches_off(out_of_strip, want, 0.6, pages, 15)["within_limits"]
    j = next(i for i, r in enumerate(want) if r[1] != "noise")
    word = [list(r) for r in want]
    f, lbl, (x, y, w, h), sc = want[j]
    word[j] = [f, lbl, [x + 4, y, w, h], sc]
    assert not chip_smoke._matches_off(word, want, 0.6, pages, 15)["within_limits"]


def test_smoke_names_the_unresolved_windows():
    """``chip_smoke.py::_ncc_unresolved`` holds on the near-white windows
    where the JAX matcher's float32 map passes 1 on a registered page, and
    not on the template's own window."""
    import chip_smoke

    from marie_tpu.components.template_matching.ncc_matcher import _ncc_jit
    from marie_tpu_torch.components.document_registration import (
        DocumentBoundaryRegistration,
    )
    from marie_tpu_torch.components.document_registration.boundary import rotate_page
    from marie_tpu_torch.components.template_matching.ncc_matcher import _gray01

    page = np.stack([_shipped([0])[0][0]] * 3, -1)
    skewed = rotate_page(torch.from_numpy(page), np.float32(np.radians(2.2))).numpy()
    aligned = DocumentBoundaryRegistration(use_model=False, device="cpu").register(skewed).aligned
    gray = _gray01(aligned)
    tpl = aligned[40:64, 40:100]
    boxes, scores, keep = jax.device_get(
        _ncc_jit(jnp.asarray(gray), jnp.asarray(_gray01(tpl)), 24, 60, 32))
    noisy = [[int(x0), int(y0), 60, 24] for (x0, y0, _, _), s in zip(boxes, scores) if s > 1.0]
    assert noisy
    assert all(chip_smoke._ncc_unresolved(aligned, tpl, b, 0.8) for b in noisy)
    assert not chip_smoke._ncc_unresolved(aligned, tpl, [40, 40, 60, 24], 0.8)
