"""The port's LayoutLM encoder, heads and document components against the
JAX package's, on the CPU at tiny widths: the same flax-layout weights
(drawn from a seed through the bridge) and the same numpy inputs go
through both.

Tolerances: logits within 1e-5 (float32, summed in another order by XLA
and torch; measured differences are ~1e-6); component dicts equal, their
float scores within 1e-5.  The classifier resizes page images with a
torch bilinear resize that agrees with the JAX side's cv2.resize within
one uint8 level; the parity cases use images whose resize is exact
(the same size, and a 2x downscale), and the resize itself is held to
cv2 separately.
"""

import dataclasses

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from marie_tpu.components.base import PageInput as JaxPageInput
from marie_tpu.components.document_classifier import (
    LayoutDocumentClassifier as JaxClassifier,
)
from marie_tpu.components.document_indexer import LayoutDocumentIndexer as JaxIndexer
from marie_tpu.components.document_indexer import aggregation as jagg
from marie_tpu.components.document_indexer import validator as jval
from marie_tpu.components.document_splitter import LayoutDocumentSplitter as JaxSplitter
from marie_tpu.components.word_tokenizer import HashWordTokenizer as JaxHash
from marie_tpu.components.word_tokenizer import RollingWordTokenizer as JaxRolling
from marie_tpu.models import configs as jcfg
from marie_tpu.models import layoutlm as jl
from marie_tpu_torch.components.base import PageInput
from marie_tpu_torch.components.document_classifier import LayoutDocumentClassifier
from marie_tpu_torch.components.document_classifier.layoutlm_classifier import (
    resize_page_image,
)
from marie_tpu_torch.components.document_indexer import LayoutDocumentIndexer
from marie_tpu_torch.components.document_indexer import aggregation as tagg
from marie_tpu_torch.components.document_indexer import validator as tval
from marie_tpu_torch.components.document_splitter import LayoutDocumentSplitter
from marie_tpu_torch.components.word_tokenizer import HashWordTokenizer, RollingWordTokenizer
from marie_tpu_torch.models import configs as tcfg
from marie_tpu_torch.models import layoutlm as tl
from marie_tpu_torch.registry.convert import build_model, from_flax, init_flax_layout

ATOL = 1e-5
CPU = torch.device("cpu")


def _configs(num_labels=3, **kw):
    """(JAX, port) LayoutLMConfig.tiny with overrides."""
    j = dataclasses.replace(jcfg.LayoutLMConfig.tiny(num_labels), **kw)
    t = dataclasses.replace(tcfg.LayoutLMConfig.tiny(num_labels), **kw)
    return j, t


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _inputs(seed, b=3, l=20, vocab=128, image_hw=(32, 32)):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (b, l)).astype(np.int32)
    boxes = rng.integers(0, 1024, (b, l, 4)).astype(np.int32)
    seq_len = np.array([5, l, 1][:b], np.int32)
    image = rng.random((b, *image_hw, 3)).astype(np.float32)
    return tokens, boxes, seq_len, image


def _t(x):
    return None if x is None else torch.from_numpy(x)


def test_layout_embeddings_match_flax():
    jc, tc = _configs()
    tree = init_flax_layout(tc, 0, "sequence")["params"]["encoder"]["embeddings"]
    tokens, boxes, _, _ = _inputs(1)
    boxes[0, :3] = [[1100, -5, 2000, 3], [10, 10, 5, 5], [1023, 1023, 1023, 1023]]  # clipped
    want = np.asarray(jl.LayoutEmbeddings(jc).apply({"params": _jnp(tree)}, tokens, boxes))
    module = from_flax(tree, tl.LayoutEmbeddings(tc))
    with torch.no_grad():
        got = module(_t(tokens), _t(boxes)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("use_image", [True, False])
@pytest.mark.parametrize("with_seq_len", [True, False])
@pytest.mark.parametrize("with_image", [True, False])
def test_encoder_matches_flax(use_image, with_seq_len, with_image):
    """The encoder with and without a length mask and an image (with
    both, the visual tokens go in front and come back after ``ln_f``)."""
    jc, tc = _configs(use_image=use_image)
    tree = init_flax_layout(tc, 1, "token")["params"]["encoder"]
    tokens, boxes, seq_len, image = _inputs(2)
    seq_len = seq_len if with_seq_len else None
    image = image if with_image else None
    want = np.asarray(jl.LayoutLMv3Encoder(jc).apply(
        {"params": _jnp(tree)}, tokens, boxes, None if seq_len is None else seq_len,
        None if image is None else image))
    module = from_flax(tree, tl.LayoutLMv3Encoder(tc)).eval()
    with torch.no_grad():
        got = module(_t(tokens), _t(boxes), _t(seq_len), _t(image)).numpy()
    assert got.shape == want.shape
    n_text = tokens.shape[1]
    assert got.shape[1] == n_text + (tc.n_patches if use_image and with_image else 0)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("head", ["sequence", "token"])
@pytest.mark.parametrize("use_image", [True, False])
def test_heads_match_flax(head, use_image):
    jc, tc = _configs(num_labels=4, use_image=use_image)
    jmodel = (jl.LayoutLMv3ForSequenceClassification if head == "sequence"
              else jl.LayoutLMv3ForTokenClassification)(jc)
    tree = init_flax_layout(tc, 2, head)
    module = from_flax(tree, build_model(tc, head)).eval()
    tokens, boxes, seq_len, image = _inputs(3)
    for s, im in ((seq_len, image), (None, image), (seq_len, None), (None, None)):
        want = np.asarray(jmodel.apply(_jnp(tree), tokens, boxes, s, im))
        with torch.no_grad():
            got = module(_t(tokens), _t(boxes), _t(s), _t(im)).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("length", [10, 16, 41])
def test_sliding_windows_and_merge_match_jax(length):
    """L < window, L = window and L > window with a remainder (starts 0,
    8, 16, 24 and a last one clamped to L - window)."""
    window, stride = 16, 8
    rng = np.random.default_rng(length)
    tokens = rng.integers(1, 100, length).astype(np.int32)
    boxes = rng.integers(0, 1024, (length, 4)).astype(np.int32)
    want = jl.sliding_windows(jnp.asarray(tokens), jnp.asarray(boxes), window, stride)
    got = tl.sliding_windows(_t(tokens), _t(boxes), window, stride)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    n = got[0].shape[0]
    assert n == (1 if length <= window else 1 + -(-(length - window) // stride))
    logits = rng.standard_normal((n, window, 5)).astype(np.float32)
    merged = tl.merge_window_logits(_t(logits), got[2], got[3], length).numpy()
    want_m = np.asarray(jl.merge_window_logits(jnp.asarray(logits), want[2], want[3],
                                               length))
    np.testing.assert_allclose(merged, want_m, atol=1e-6)


WORDS = ["Invoice", "total", "11/02/2023", "$1,234.50", "555-123-4567", "Main",
         "St", "Springfield", "IL", "62704", "a", ""]


@pytest.mark.parametrize("tok_pair", ["hash", "rolling"])
def test_word_tokenizers_match_jax(tok_pair):
    t, j = ((HashWordTokenizer(512), JaxHash(512)) if tok_pair == "hash"
            else (RollingWordTokenizer(512), JaxRolling(512)))
    assert [t.token_id(w) for w in WORDS] == [j.token_id(w) for w in WORDS]
    rng = np.random.default_rng(4)
    boxes = [[float(x) for x in rng.uniform(0, 500, 4)] for _ in WORDS]
    for max_len in (4, 12, 20):
        got = t.encode_page(WORDS, boxes, (640, 480), max_len, 1024)
        want = j.encode_page(WORDS, boxes, (640, 480), max_len, 1024)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]


def _pages(seed, n_pages, n_words, images):
    """Port and JAX PageInputs with the same words, boxes and images."""
    rng = np.random.default_rng(seed)
    out_t, out_j = [], []
    for p in range(n_pages):
        words = [WORDS[int(i)] for i in rng.integers(0, len(WORDS) - 1, n_words)]
        xs = rng.uniform(0, 600, n_words)
        ys = np.repeat(np.arange(-(-n_words // 6)) * 30.0 + 10, 6)[:n_words]
        boxes = [[float(x), float(y), float(rng.uniform(20, 80)), 16.0]
                 for x, y in zip(xs, ys)]
        image = images[p % len(images)] if images else None
        size = None if image is not None else (768, 1024)
        out_t.append(PageInput(words, boxes, image, size))
        out_j.append(JaxPageInput(words, boxes, image, size))
    return out_t, out_j


def assert_close_tree(got, want, atol=ATOL, path="$"):
    """Equal structure and values; floats within ``atol``."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            assert_close_tree(got[k], want[k], atol, f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close_tree(g, w, atol, f"{path}[{i}]")
    elif isinstance(want, float):
        assert isinstance(got, float) and abs(got - want) <= atol, (path, got, want)
    else:
        assert got == want, (path, got, want)


def test_classifier_predict_matches_jax():
    """predict() dicts with the image branch: a 2-D page image at twice the
    image size, an RGB one at the image size and a page without an image
    (white), 5 pages padded to a batch of 8."""
    labels = ("invoice", "letter", "claim")
    jc, tc = _configs(num_labels=3)
    tree = init_flax_layout(tc, 5, "sequence")
    rng = np.random.default_rng(6)
    images = [rng.integers(0, 256, (64, 64)).astype(np.uint8),
              rng.integers(0, 256, (32, 32, 3)).astype(np.uint8), None]
    pt, pj = _pages(7, 5, 9, images)
    pt[2].image = pj[2].image = None
    got = LayoutDocumentClassifier(labels, tc, tree, device="cpu").predict(pt)
    want = JaxClassifier(labels, jc, _jnp(tree)).predict(pj)
    assert_close_tree(got, want)
    assert LayoutDocumentClassifier(labels, tc, tree, device="cpu").predict([]) == []


@pytest.mark.parametrize("n_words", [10, 16, 41])
def test_indexer_index_matches_jax(n_words):
    """index() dicts with validators and composite groups, for pages of
    one window, exactly one window and five overlapping windows."""
    labels = ("O", "B-DATE", "I-DATE", "B-AMOUNT", "I-AMOUNT", "B-STREET", "I-STREET")
    jc, tc = _configs(num_labels=len(labels), use_image=False, max_seq_len=16)
    tree = init_flax_layout(tc, 8, "token")
    pt, pj = _pages(9 + n_words, 2, n_words, None)
    groups = [{"name": "ADDRESS", "entities": ["STREET"]},
              {"name": "DATES", "entities": ["DATE", "AMOUNT"]}]
    got = LayoutDocumentIndexer(labels, tc, tree, stride=8, device="cpu").index(
        pt, entities_to_group=groups)
    want = JaxIndexer(labels, jc, _jnp(tree), stride=8).index(pj, entities_to_group=groups)
    assert_close_tree(got, want)
    assert sum(len(r["entities"]) for r in got) > 0
    assert any("valid" in e for r in got for e in r["entities"])
    empty = LayoutDocumentIndexer(labels, tc, tree, stride=8, device="cpu")
    assert empty.index([PageInput([], [])]) == [{"entities": []}]


def test_splitter_split_and_documents_match_jax():
    jc, tc = _configs(num_labels=2)
    tree = init_flax_layout(tc, 10, "sequence")
    pt, pj = _pages(11, 6, 7, None)
    got = LayoutDocumentSplitter(config=tc, params=tree, device="cpu").split(pt)
    want = JaxSplitter(config=jc, params=_jnp(tree)).split(pj)
    assert_close_tree(got, want)
    assert got[0]["is_boundary"]
    assert LayoutDocumentSplitter.to_documents(got) == JaxSplitter.to_documents(want)
    flags = [{"is_boundary": b} for b in (True, False, True, True, False)]
    assert LayoutDocumentSplitter.to_documents(flags) == [[0, 1], [2], [3, 4]]


@pytest.mark.parametrize("src_hw,out_hw,channels", [
    ((1024, 768), (224, 224), 0), ((100, 37), (224, 224), 3), ((37, 300), (32, 32), 3),
    ((64, 64), (32, 32), 0), ((224, 224), (224, 224), 0),
])
def test_resize_matches_cv2(src_hw, out_hw, channels):
    """The classifier's torch resize against cv2.resize (INTER_LINEAR) /
    255, within one uint8 level; a 2-D page comes back with 3 channels."""
    rng = np.random.default_rng(sum(src_hw))
    shape = src_hw if channels == 0 else (*src_hw, channels)
    img = rng.integers(0, 256, shape).astype(np.uint8)
    want = cv2.resize(img, (out_hw[1], out_hw[0])).astype(np.float32) / 255.0
    if want.ndim == 2:
        want = np.stack([want] * 3, -1)
    got = resize_page_image(img, out_hw, CPU).numpy()
    assert got.shape == (*out_hw, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1.0 / 255 + 1e-6)


def test_from_flax_is_strict():
    """A missing key and an extra key each raise; build_model refuses a
    LayoutLM config without a head name."""
    _, tc = _configs()
    tree = init_flax_layout(tc, 0, "sequence")
    missing = jax.tree_util.tree_map(lambda x: x, tree)
    del missing["params"]["encoder"]["ln_f"]["bias"]
    with pytest.raises(RuntimeError):
        from_flax(missing, build_model(tc, "sequence"))
    extra = jax.tree_util.tree_map(lambda x: x, tree)
    extra["params"]["encoder"]["ln_f"]["extra"] = np.zeros(64, np.float32)
    with pytest.raises((RuntimeError, AttributeError)):
        from_flax(extra, build_model(tc, "sequence"))
    with pytest.raises((RuntimeError, AttributeError)):
        from_flax(tree, build_model(tc, "token"))  # the other head's tree
    with pytest.raises(ValueError):
        build_model(tc)


def test_components_refuse_the_zoo():
    """The zoo loaders refuse trees the port's zoo lacks (the -synth heads
    are not shipped): ``from_zoo`` returns None, and the splitter's
    default falls back to the classifier's seeded base-width weights, as
    the JAX splitter does without its checkpoint; the chain heads load
    (``tests/test_torch_zoo.py`` holds them to JAX)."""
    assert LayoutDocumentClassifier.from_zoo(device="cpu") is None
    assert LayoutDocumentIndexer.from_zoo(device="cpu") is None
    assert LayoutDocumentClassifier.from_zoo("nope", device="cpu") is None
    assert LayoutDocumentIndexer.from_zoo_chain(device="cpu").zoo_name == "layout-indexer-chain"
    splitter = LayoutDocumentSplitter(device="cpu")
    assert splitter.classifier.zoo_name is None
    assert splitter.classifier.config == tcfg.LayoutLMConfig.base(num_labels=2)
    with pytest.raises(ValueError):
        LayoutDocumentClassifier(("a", "b"), tcfg.LayoutLMConfig.tiny(3), device="cpu")


VALUES = ["11/02/2023", "Nov 2, 2023", "2023-13-01", "$1,234.50", "(42.00", "(42.00)",
          "555-123-4567", "+1 555 123 4567", "123", "123 Main St, Springfield, IL 62704",
          "Main St, Springfield, IL 62704", "123 Main St, Springfield, ZZ 62704"]


@pytest.mark.parametrize("label", ["DATE", "AMOUNT", "PHONE", "ADDRESS"])
def test_validators_match_jax(label):
    def run(get):
        out = []
        for v in VALUES:
            try:
                out.append(("ok", get(label)(v)))
            except ValueError as e:
                out.append(("err", str(e)))
        return out

    assert run(tval.get_validator) == run(jval.get_validator)


def test_aggregation_matches_jax():
    lines = [[10, 10, 400, 20], [10, 40, 400, 20], [10, 200, 400, 20]]
    boxes = [[10, 10, 60, 18], [80, 10, 60, 18], [200, 10, 70, 18], [10, 40, 90, 18],
             [110, 40, 70, 18], [10, 200, 50, 18], [100, 10, 60, 18]]
    preds = ["B-STREET", "I-STREET", "B-CITY", "B-STREET", "I-CITY", "B-ZIP", "B-STREET"]
    scores = [0.9, 0.8, 0.95, 0.85, 0.9, 0.7, 0.6]
    defs = [{"name": "ADDRESS", "entities": ["STREET", "CITY", "ZIP"]}]
    got = tagg.group_composites(defs, lines, boxes, preds, scores)
    want = jagg.group_composites(defs, lines, boxes, preds, scores)
    assert ({k: [dataclasses.asdict(g) for g in v] for k, v in got.items()}
            == {k: [dataclasses.asdict(g) for g in v] for k, v in want.items()})
    assert (tagg.group_predictions_by_line(lines, boxes, preds)
            == jagg.group_predictions_by_line(lines, boxes, preds))
