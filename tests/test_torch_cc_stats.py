"""The port's five component-stats variants against the JAX package's
(``marie_tpu/ops/connected_components.py``) and against each other.

Limit: equality.  Every output (boxes, areas, scores, valid) is compared
with ``np.testing.assert_array_equal``: the stats are exact minima,
maxima and integer counts of the same inputs, so any difference is a
fault.  Cases: random masks with random scores in [-0.5, 1.5) (negative
scores show each variant's score floor), the component budget overrun
(the drop by name), ``runs`` past its per-row run budget, the pixel
labels of ``connected_components``, ``detect_core`` under each
``cc_stats`` on a tiny CRAFT (ink boxes) against the JAX ``_detect_core``
under ``MARIE_CC_STATS``, and the engine under each variant against
``runs_cc``.
"""

import importlib

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from marie_tpu_torch.boxes.craft_box_processor import (
    CC_STATS,
    BoxProcessorCraft,
    detect_core,
)
from marie_tpu_torch.models import configs as tcfg
from marie_tpu_torch.ocr.ocr_engine import PipelineOcrEngine
from marie_tpu_torch.preprocess.buckets import BucketSpec
from marie_tpu_torch.registry.convert import init_flax_layout

J = importlib.import_module("marie_tpu.ops.connected_components")
T = importlib.import_module("marie_tpu_torch.ops.connected_components")

H, W = 24, 40
#: (name, JAX function, port function): the pixel-label variants
PIXEL = (
    ("sort", J.component_boxes, T.component_boxes),
    ("reduce", J.component_boxes_reduce, T.component_boxes_reduce),
    ("reduce2", J.component_boxes_reduce2, T.component_boxes_reduce2),
    ("runs", J.component_boxes_runs, T.component_boxes_runs),
)


def _mask(seed: int, density: float, h: int = H, w: int = W):
    rng = np.random.default_rng(seed)
    mask = rng.random((h, w)) < density
    scores = (rng.random((h, w)) * 2.0 - 0.5).astype(np.float32)
    return mask, scores


def _equal(got, want, msg=""):
    assert set(got) == set(want)
    for key in want:
        g, w = got[key].numpy(), np.asarray(want[key])
        assert g.dtype == w.dtype, (msg, key, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{msg} {key}")


def _both(name, jf, tf, labels, mask, scores, k, **kw):
    src = mask if name == "runs_cc" else labels
    sc = None if scores is None else scores
    want = jf(jnp.asarray(src), None if sc is None else jnp.asarray(sc), max_components=k,
              **kw)
    got = tf(torch.from_numpy(src), None if sc is None else torch.from_numpy(sc),
             max_components=k, **kw)
    return got, want


@settings(max_examples=8, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), density=st.sampled_from([0.15, 0.35, 0.55, 0.8]),
       with_scores=st.booleans())
def test_variants_match_jax_and_each_other(seed, density, with_scores):
    """All five variants equal the JAX ones on random masks, and each
    other (``sort``'s score has no floor, so with scores that can be
    negative it is compared against JAX alone)."""
    mask, scores = _mask(seed, density)
    scores = scores if with_scores else None
    labels = np.asarray(J.connected_components(jnp.asarray(mask)))
    np.testing.assert_array_equal(T.connected_components(torch.from_numpy(mask)).numpy(),
                                  labels)
    k = 48
    outs = {}
    for name, jf, tf in PIXEL + (("runs_cc", J.component_boxes_runs_cc,
                                  T.component_boxes_runs_cc),):
        got, want = _both(name, jf, tf, labels, mask, scores, k)
        _equal(got, want, name)
        outs[name] = got
    for name in ("reduce", "reduce2", "runs"):
        _equal(outs[name], outs["runs_cc"], f"{name} vs runs_cc")
    nonneg = None if scores is None else torch.from_numpy(np.clip(scores, 0.0, None))
    got = T.component_boxes(torch.from_numpy(labels), nonneg, max_components=k)
    ref = T.component_boxes_runs_cc(torch.from_numpy(mask), nonneg, max_components=k)
    _equal(got, {key: v.numpy() for key, v in ref.items()}, "sort vs runs_cc")


@pytest.mark.parametrize("k", [4, 300])
def test_past_max_components(k):
    """More components than slots: the K smallest names are kept, in
    every variant, as in JAX (K past the component count leaves empty
    slots)."""
    mask, scores = _mask(5, 0.3, 32, 48)
    labels = np.asarray(J.connected_components(jnp.asarray(mask)))
    assert len(np.unique(labels[labels >= 0])) > 16
    for name, jf, tf in PIXEL:
        got, want = _both(name, jf, tf, labels, mask, scores, k)
        _equal(got, want, name)
    if k <= 32 * 48:
        got, want = _both("runs_cc", J.component_boxes_runs_cc, T.component_boxes_runs_cc,
                          labels, mask, scores, min(k, 32 * 48 // 2), max_runs_per_row=48)
        _equal(got, want, "runs_cc")


@pytest.mark.parametrize("budget", [1, 2, 3])
def test_runs_past_its_run_budget(budget):
    """A row with more runs than ``max_runs_per_row`` drops its rightmost
    runs in ``runs`` and ``runs_cc``, as in JAX: a component whose runs
    were all dropped keeps its slot in ``runs`` (box ``[H*W, y0, 0, 0]``,
    area 0)."""
    mask = np.zeros((10, 64), bool)
    for i in range(4):
        mask[:, i * 16 + 2: i * 16 + 9] = True
    mask[3, :] = False
    mask[7, 40:] = False
    scores = np.random.default_rng(1).random((10, 64)).astype(np.float32) - 0.2
    labels = np.asarray(J.connected_components(jnp.asarray(mask)))
    for name, jf, tf in (("runs", J.component_boxes_runs, T.component_boxes_runs),
                         ("runs_cc", J.component_boxes_runs_cc, T.component_boxes_runs_cc)):
        # JAX's run-domain top-k takes at most H * budget slots
        k = 16 if name == "runs" else min(16, 10 * budget)
        got, want = _both(name, jf, tf, labels, mask, scores, k, max_runs_per_row=budget)
        _equal(got, want, name)
    got, _ = _both("runs", J.component_boxes_runs, T.component_boxes_runs, labels, mask,
                   scores, 16, max_runs_per_row=1)
    lost = got["valid"] & (got["areas"] == 0)
    assert bool(lost.any())
    assert (got["boxes"][lost][:, 0] == 10 * 64).all()


@pytest.fixture(scope="module")
def tiny_craft():
    return init_flax_layout(tcfg.CraftConfig.tiny(), 7)


def _ink_pages(n: int = 2):
    rng = np.random.default_rng(3)
    pages = np.full((n, 128, 192), 255, np.uint8)
    for p in range(n):
        for _ in range(14):
            y, x = int(rng.integers(4, 110)), int(rng.integers(4, 150))
            pages[p, y:y + int(rng.integers(6, 14)), x:x + int(rng.integers(10, 40))] = \
                int(rng.integers(0, 90))
    return pages


@pytest.mark.parametrize("cc_stats", sorted(CC_STATS))
def test_detect_core_matches_jax(tiny_craft, cc_stats, monkeypatch):
    """``detect_core(cc_stats=...)`` on a tiny CRAFT (ink boxes, so the
    mask does not hang on float rounding) equals the JAX ``_detect_core``
    under ``MARIE_CC_STATS``."""
    from marie_tpu.boxes.craft_box_processor import _detect_core
    from marie_tpu.models.configs import CraftConfig
    from marie_tpu.models.craft import CRAFT

    bp = BoxProcessorCraft(tcfg.CraftConfig.tiny(), tiny_craft, box_source="ink",
                           device="cpu", cc_stats=cc_stats)
    pages = _ink_pages()
    got = detect_core(bp.model, torch.from_numpy(pages), 0.7, 0.4, 0.4, 32, "ink",
                      **{"cc_stats": cc_stats, "cc_runs": 48})
    monkeypatch.setenv("MARIE_CC_STATS", cc_stats)
    want = _detect_core(CRAFT(CraftConfig.tiny()),
                        jax.tree_util.tree_map(jnp.asarray, tiny_craft), jnp.asarray(pages),
                        0.7, 0.4, 0.4, 32, "ink")
    assert int(np.asarray(want["valid"]).sum()) >= 10
    _equal(got, want, cc_stats)


@pytest.mark.parametrize("cc_stats", ["reduce", "reduce2", "runs", "sort"])
def test_engine_variants_equal_runs_cc(tiny_craft, cc_stats):
    """``BoxProcessorCraft(cc_stats=...)`` carries the variant into the
    fused page program: the engine's results equal those under
    ``runs_cc`` (which ``test_torch_engine.py`` holds to JAX)."""
    from marie_tpu_torch.document.trocr_ocr_processor import TrOcrProcessor

    op = TrOcrProcessor(tcfg.TrOCRConfig.tiny(), init_flax_layout(tcfg.TrOCRConfig.tiny(), 8),
                        batch_sizes=(8, 32), device="cpu")
    pages = list(_ink_pages())
    results = {}
    for name in ("runs_cc", cc_stats):
        bp = BoxProcessorCraft(tcfg.CraftConfig.tiny(), tiny_craft, box_source="ink",
                               max_components=64, bucket_spec=BucketSpec(shapes=((128, 192),)),
                               device="cpu", cc_stats=name)
        results[name] = PipelineOcrEngine(bp, op, page_fuse_batch=2).extract(pages)
    assert sum(len(r["words"]) for r in results["runs_cc"]) >= 10
    assert results[cc_stats] == results["runs_cc"]
