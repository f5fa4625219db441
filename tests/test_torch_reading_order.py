"""The port's reading order (``marie_tpu_torch/models/reading_order.py``,
``document/layoutreader.py``) against the JAX package's on the CPU, with
the same flax-layout trees.

* Tiny width, random numpy trees: scores within 1e-5.
* The trained ``model_zoo/reading-order-synth`` tree on the 16 shipped
  pages' golden OCR words: orders equal (adjacent swaps of near ties are
  counted by ``check.order_swaps``; none is expected) and scores within
  1e-5 of the page's largest score.  The matmuls equal XLA's to the bit;
  LayerNorm, softmax and GELU round differently (XLA's CPU rsqrt is a
  hardware estimate refined by a Newton step), and the trained head
  turns that into ~3e-4 on scores up to ~62 (measured 3.3e-4), so an
  absolute 1e-5 holds only for the seeded trees.
* The seeded base tree on the same pages (scores ~1) within 1e-5, and on
  the 600-word page of ``chip_smoke.long_page_boxes`` (three bands).
* ``reorder_page_result`` equals JAX's on golden page results.
* ``from_flax`` is strict about the tree's keys.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke as cs
from marie_tpu.document.layoutreader import reorder_page_result as jax_reorder
from marie_tpu.models.reading_order import ReadingOrderConfig as JaxConfig
from marie_tpu.models.reading_order import ReadingOrderModel as JaxModel
from marie_tpu.models.reading_order import TextLayout as JaxTextLayout
from marie_tpu.models.reading_order import _score_boxes
from marie_tpu_torch.check import order_swaps
from marie_tpu_torch.document.layoutreader import (
    load_text_layout, page_word_boxes, reorder_page_result)
from marie_tpu_torch.models.reading_order import (
    ReadingOrderConfig, ReadingOrderModel, TextLayout, box_features)
from marie_tpu_torch.registry.convert import from_flax, init_flax_layout
from marie_tpu_torch.registry.zoo import open_zoo_json

ATOL = 1e-5
SWAP_GAP = 2e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _jax_order_and_scores(layout, boxes, scale):
    """JAX ``TextLayout.order``'s bands, with each box's score."""
    arr = np.asarray(boxes, np.float32) / float(scale)
    n, nb = len(arr), layout.cfg.max_boxes
    bands = ([np.arange(n)] if n <= nb else
             [np.argsort(arr[:, 1], kind="stable")[s:s + nb] for s in range(0, n, nb)])
    scores, order = np.zeros(n, np.float32), []
    for idx in bands:
        k = len(idx)
        padded = np.zeros((1, nb, 4), np.float32)
        padded[0, :k] = arr[idx]
        got = np.asarray(_score_boxes(layout.model, layout.params, jnp.asarray(padded),
                                      jnp.asarray([k], jnp.int32)))[0, :k]
        scores[idx] = got
        order += [int(idx[i]) for i in np.argsort(got, kind="stable")]
    return order, scores


@pytest.fixture(scope="module")
def golden_pages():
    with open_zoo_json("golden") as f:
        return json.load(f)["pages"]


@pytest.fixture(scope="module")
def trained_tree():
    if not os.path.isdir(os.path.join(REPO, "model_zoo", "reading-order-synth")):
        pytest.skip("model_zoo/reading-order-synth is not present")
    from marie_tpu.registry.zoo import zoo_params

    return jax.device_get(zoo_params("reading-order-synth"))


def test_box_features_match():
    rng = np.random.default_rng(3)
    boxes = np.sort(rng.random((2, 7, 4)).astype(np.float32), axis=-1)
    from marie_tpu.models.reading_order import box_features as jax_features

    np.testing.assert_array_equal(box_features(torch.from_numpy(boxes)).numpy(),
                                  np.asarray(jax_features(jnp.asarray(boxes))))


@pytest.mark.parametrize("seed", [1, 2])
def test_tiny_model_matches_jax(seed):
    """Tiny width, a random numpy tree, two pages padded to 256 with
    their own valid counts: the scores of the valid rows within 1e-5."""
    cfg = ReadingOrderConfig.tiny()
    tree = init_flax_layout(cfg, seed)
    rng = np.random.default_rng(seed)
    xy = rng.random((2, 256, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + rng.random((2, 256, 2)).astype(np.float32) * 0.1], -1)
    n_valid = np.array([37, 201], np.int32)
    want = np.asarray(JaxModel(JaxConfig.tiny()).apply(_jnp(tree), jnp.asarray(boxes),
                                                       jnp.asarray(n_valid)))
    model = from_flax(tree, ReadingOrderModel(cfg)).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(boxes), torch.from_numpy(n_valid)).numpy()
    for b, n in enumerate(n_valid):
        np.testing.assert_allclose(got[b, :n], want[b, :n], atol=ATOL, rtol=0)


def test_trained_tree_orders_the_shipped_pages(trained_tree, golden_pages):
    """The trained tree on the 16 pages' golden OCR words: the port's
    order equals JAX's (no near-tie swap) and its scores are within 1e-5
    of the page's largest |score|."""
    jax_layout = JaxTextLayout(JaxConfig.base(), _jnp(trained_tree))
    layout = TextLayout(ReadingOrderConfig.base(), trained_tree, device="cpu")
    swaps, worst = 0, 0.0
    for page in golden_pages:
        boxes, scale = page_word_boxes(page)
        want, want_scores = _jax_order_and_scores(jax_layout, boxes, scale)
        assert want == jax_layout.order(boxes, scale=scale)
        got, got_scores = layout.order_and_scores(boxes, scale=scale)
        span = float(np.abs(want_scores).max())
        worst = max(worst, float(np.abs(got_scores - want_scores).max()) / span)
        swaps += order_swaps(got, want, want_scores, SWAP_GAP * span)
        assert got == layout.order(boxes, scale)
    assert worst <= ATOL, worst
    assert swaps == 0


def test_seeded_tree_orders_the_pages_and_the_long_page(golden_pages):
    """The seeded base tree (the card's) on 4 shipped pages and on the
    600-word page, ordered in three bands of 256: scores within 1e-5,
    orders equal but for counted near-tie swaps."""
    tree = init_flax_layout(ReadingOrderConfig.base(), cs.READING_ORDER_SEED)
    jax_layout = JaxTextLayout(JaxConfig.base(), _jnp(tree))
    layout = TextLayout(ReadingOrderConfig.base(), tree, device="cpu")
    long_page = cs.long_page_boxes()
    cases = [page_word_boxes(p) for p in golden_pages[:4]] + [(long_page, 1024.0)]
    swaps = 0
    for boxes, scale in cases:
        want, want_scores = _jax_order_and_scores(jax_layout, boxes, scale)
        got, got_scores = layout.order_and_scores(boxes, scale=scale)
        np.testing.assert_allclose(got_scores, want_scores, atol=ATOL, rtol=0)
        swaps += order_swaps(got, want, want_scores, SWAP_GAP)
    assert len(long_page) > 2 * ReadingOrderConfig.base().max_boxes
    assert swaps <= 2, swaps


def test_reorder_page_result_matches_jax(trained_tree, golden_pages):
    """``reorder_page_result`` on golden page results equals JAX's dicts:
    words in the new order with new ids, each line's ids and text."""
    jax_layout = JaxTextLayout(JaxConfig.base(), _jnp(trained_tree))
    layout = TextLayout(ReadingOrderConfig.base(), trained_tree, device="cpu")
    for page in golden_pages[:3]:
        got = reorder_page_result(page, layout)
        assert got == jax_reorder(page, jax_layout)
        assert [w["id"] for w in got["words"]] == list(range(len(page["words"])))
        assert sorted(w["text"] for w in got["words"]) == sorted(
            w["text"] for w in page["words"])
        assert got["meta"] == page["meta"]
    one = dict(golden_pages[0], words=golden_pages[0]["words"][:1])
    assert reorder_page_result(one, layout) is one


def test_load_text_layout_falls_back_to_the_seeded_tree():
    """Without a zoo tree the loader draws ``init_flax_layout(cfg, 0)``
    and says it is untrained; a ``.npz`` checkpoint loads strictly."""
    cfg = ReadingOrderConfig.tiny()
    layout = load_text_layout(config=cfg, device="cpu")
    assert layout.trained is None and layout.device.type == "cpu"
    seeded = TextLayout(cfg, init_flax_layout(cfg, 0), device="cpu")
    boxes = [[10, 10, 50, 20], [60, 10, 90, 20], [10, 40, 50, 50]]
    assert layout.order(boxes) == seeded.order(boxes)
    assert layout([" a", "b", "c"], boxes) == (
        [[" a", "b", "c"][i] for i in layout.order(boxes)],
        [boxes[i] for i in layout.order(boxes)])
    assert layout.order([]) == []


def test_load_text_layout_reads_a_checkpoint(tmp_path):
    from marie_tpu_torch.registry.checkpoints import save_params

    cfg = ReadingOrderConfig.tiny()
    tree = init_flax_layout(cfg, 5)
    path = str(tmp_path / "ro.npz")
    save_params(tree, path)
    layout = load_text_layout(path, cfg, device="cpu")
    assert layout.trained == path
    np.testing.assert_array_equal(layout.model.head.weight.numpy(),
                                  tree["params"]["head"]["kernel"].T)


def test_from_flax_is_strict():
    cfg = ReadingOrderConfig.tiny()
    tree = init_flax_layout(cfg, 0)
    del tree["params"]["ln_f"]["bias"]
    with pytest.raises(RuntimeError, match="Missing"):
        from_flax(tree, ReadingOrderModel(cfg))
    tree = init_flax_layout(cfg, 0)
    tree["params"]["layer_0"]["attn"]["q"]["extra"] = np.zeros(1, np.float32)
    with pytest.raises(RuntimeError, match="Unexpected"):
        from_flax(tree, ReadingOrderModel(cfg))
    names = {"embed", "ln_f", "head"} | {f"layer_{i}" for i in range(cfg.num_layers)}
    assert set(init_flax_layout(cfg, 0)["params"]) == names


def test_text_layout_defaults_to_the_card():
    import inspect

    assert inspect.signature(TextLayout).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            TextLayout(ReadingOrderConfig.tiny())
        with pytest.raises(RuntimeError):
            load_text_layout(config=ReadingOrderConfig.tiny())


def test_order_swaps_counts_near_ties_only():
    """The swap rule of the card checks: equal orders count 0; an
    adjacent pair swapped counts 1 where its reference scores are closer
    than the gap; a far pair, a longer move or other boxes fail."""
    scores = [0.0, 0.1, 0.10001, 0.5]
    assert order_swaps([0, 1, 2, 3], [0, 1, 2, 3], scores, 1e-4) == 0
    assert order_swaps([0, 2, 1, 3], [0, 1, 2, 3], scores, 1e-4) == 1
    with pytest.raises(AssertionError, match="near-tie"):
        order_swaps([1, 0, 2, 3], [0, 1, 2, 3], scores, 1e-4)
    with pytest.raises(AssertionError, match="near-tie"):
        order_swaps([0, 3, 1, 2], [0, 1, 2, 3], scores, 1.0)
    with pytest.raises(AssertionError, match="different boxes"):
        order_swaps([0, 1, 2, 2], [0, 1, 2, 3], scores, 1.0)
