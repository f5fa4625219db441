"""The port's chained OCR -> classify -> NER program and engine against the
JAX package's, case for case with ``tests/unit/test_fused_chain.py``:
the device word hash, the chain program's outputs, and ``extract`` with
chained heads (result dicts equal; float scores within the tolerances
below).

Tolerances: decode confidences, class logits and NER scores within 1e-5
(float32 matmuls summed in another order by XLA and by torch on the CPU;
measured differences are ~1e-6); the result schema's confidences are
rounded to 3 decimals and held within 1e-3, as in ``test_torch_engine.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from marie_tpu.boxes.craft_box_processor import BoxProcessorCraft as JaxBoxProcessorCraft
from marie_tpu.components.document_classifier import (
    LayoutDocumentClassifier as JaxClassifier,
)
from marie_tpu.components.document_indexer import LayoutDocumentIndexer as JaxIndexer
from marie_tpu.components.word_tokenizer import RollingWordTokenizer as JaxRolling
from marie_tpu.document.trocr_ocr_processor import TrOcrProcessor as JaxTrOcrProcessor
from marie_tpu.enums import CoordinateFormat as JaxCoordinateFormat
from marie_tpu.enums import PSMode as JaxPSMode
from marie_tpu.models import configs as jcfg
from marie_tpu.ocr.fused_chain import fused_ocr_chain as jax_fused_ocr_chain
from marie_tpu.ocr.fused_chain import rolling_word_ids as jax_rolling_word_ids
from marie_tpu.ocr.ocr_engine import PipelineOcrEngine as JaxEngine
from marie_tpu.preprocess import BucketSpec as JaxBucketSpec
from marie_tpu_torch.boxes.craft_box_processor import BoxProcessorCraft
from marie_tpu_torch.components.document_classifier import LayoutDocumentClassifier
from marie_tpu_torch.components.document_indexer import LayoutDocumentIndexer
from marie_tpu_torch.components.word_tokenizer import RollingWordTokenizer
from marie_tpu_torch.document.trocr_ocr_processor import TrOcrProcessor
from marie_tpu_torch.enums import CoordinateFormat, PSMode
from marie_tpu_torch.models import configs as tcfg
from marie_tpu_torch.ocr.fused_chain import fused_ocr_chain, rolling_word_ids
from marie_tpu_torch.ocr.ocr_engine import PipelineOcrEngine
from marie_tpu_torch.preprocess.buckets import BucketSpec
from marie_tpu_torch.registry.convert import init_flax_layout

SIDE = 96
ATOL = 1e-5
CONF_ATOL = 1e-3
CLASSES = ("a", "b", "c")
NER = ("O", "B-K", "I-K", "B-V", "I-V")


def _head_config(num_labels, seq_cap):
    """A one-layer head of 2 heads of width 32 (a width the card's
    attention kernel takes)."""
    kw = dict(vocab_size=512, hidden_dim=64, num_layers=1, num_heads=2, mlp_dim=64,
              max_seq_len=seq_cap, use_image=False, num_labels=num_labels)
    return jcfg.LayoutLMConfig(**kw), tcfg.LayoutLMConfig(**kw)


def _heads(seq_cap):
    """((JAX classifier, JAX indexer), (port classifier, port indexer))
    with the same seeded weights and RollingWordTokenizer ids."""
    jc, tc = _head_config(len(CLASSES), seq_cap)
    jn, tn = _head_config(len(NER), seq_cap)
    cls_tree = init_flax_layout(tc, 11, "sequence")
    ner_tree = init_flax_layout(tn, 12, "token")
    j = (JaxClassifier(labels=CLASSES, config=jc, tokenizer=JaxRolling(512),
                       params=jax.tree_util.tree_map(jnp.asarray, cls_tree)),
         JaxIndexer(labels=NER, config=jn, tokenizer=JaxRolling(512),
                    params=jax.tree_util.tree_map(jnp.asarray, ner_tree)))
    t = (LayoutDocumentClassifier(labels=CLASSES, config=tc, params=cls_tree,
                                  tokenizer=RollingWordTokenizer(512), device="cpu"),
         LayoutDocumentIndexer(labels=NER, config=tn, params=ner_tree,
                               tokenizer=RollingWordTokenizer(512), device="cpu"))
    return j, t


@pytest.fixture(scope="module")
def processors():
    """(JAX (bp, op), port (bp, op)): tiny float32 CRAFT and TrOCR with
    the same weights, ink boxes on 96x96 pages, recognition chunks of 16."""
    craft_tree = init_flax_layout(tcfg.CraftConfig.tiny(), 7)
    trocr_tree = init_flax_layout(tcfg.TrOCRConfig.tiny(), 8)
    jbp = JaxBoxProcessorCraft(
        config=jcfg.CraftConfig.tiny(), box_source="ink", min_area=4, max_components=16,
        bucket_spec=JaxBucketSpec(shapes=((SIDE, SIDE),)),
        variables=jax.tree_util.tree_map(jnp.asarray, craft_tree))
    jop = JaxTrOcrProcessor(config=jcfg.TrOCRConfig.tiny(), beam_size=1, batch_sizes=(16,),
                            params=jax.tree_util.tree_map(jnp.asarray, trocr_tree))
    tbp = BoxProcessorCraft(tcfg.CraftConfig.tiny(), craft_tree, box_source="ink",
                            min_area=4, max_components=16,
                            bucket_spec=BucketSpec(shapes=((SIDE, SIDE),)), device="cpu")
    top = TrOcrProcessor(tcfg.TrOCRConfig.tiny(), trocr_tree, batch_sizes=(16,), device="cpu")
    return (jbp, jop), (tbp, top)


def _page(seed, n_words):
    """A white 96x96 page with ``n_words`` ink blocks on rows 12 px apart
    (the ink mask's grid is 4 px)."""
    rng = np.random.default_rng(seed)
    page = np.full((SIDE, SIDE), 255, np.uint8)
    for i in range(n_words):
        y = 4 + 12 * i
        x = int(rng.integers(2, 40))
        page[y:y + 4, x:x + int(rng.integers(10, 40))] = int(rng.integers(0, 90))
    return page


@pytest.mark.parametrize("length", [12, 17, 32])
def test_rolling_word_ids_host_device_parity(length):
    """Device hash (port and JAX) equals the host tokenizers' ids, on
    words as long as the decode (17 steps in the serving recogniser, 32
    at the decoder's most) where 31^pos and the sum wrap past 2^32."""
    tok = RollingWordTokenizer(512)
    words = ["invoice", "total", "a", "", "2024.01", "x" * length,
             "".join(chr(33 + (7 * i) % 90) for i in range(length))]
    char_ids = np.full((len(words), length), 2, np.int32)  # PAD_ID = 2
    for i, w in enumerate(words):
        enc = tok.char_tokenizer.encode(w, add_eos=False)[:length]
        char_ids[i, :len(enc)] = enc
    host = np.asarray([tok.token_id(w) for w in words])
    jax_host = np.asarray([JaxRolling(512).token_id(w) for w in words])
    dev = rolling_word_ids(torch.from_numpy(char_ids), 512).numpy()
    jdev = np.asarray(jax.device_get(jax_rolling_word_ids(char_ids, 512)))
    assert np.array_equal(host, jax_host)
    assert np.array_equal(dev, host), (dev, host)
    assert np.array_equal(jdev, host)
    # rows with pads between chars, and every char id the decoder emits
    rng = np.random.default_rng(length)
    rows = rng.integers(0, 104, (64, length)).astype(np.int32)
    np.testing.assert_array_equal(rolling_word_ids(torch.from_numpy(rows), 8192).numpy(),
                                  np.asarray(jax_rolling_word_ids(rows, 8192)))


@pytest.mark.parametrize("seq_cap,compact_slots,n_words", [
    (16, 4, (1, 3)),
    (4, 4, (7, 1)),  # page 0 borrows page 1's rows and passes the cap
    (16, 2, (5, 4)),  # rows past the 4-row budget: clipped gathers, as in JAX
])
def test_chain_program_matches_jax(processors, seq_cap, compact_slots, n_words):
    """Stats and tokens equal, confidences, class logits and NER scores
    within 1e-5, NER labels equal."""
    (jbp, jop), (tbp, top) = processors
    (jcls, jner), (tcls, tner) = _heads(seq_cap)
    pages = np.stack([_page(20 + i, n) for i, n in enumerate(n_words)])
    want = jax.device_get(jax_fused_ocr_chain(jbp, jop, jcls, jner, pages,
                                              compact_slots=compact_slots))
    got = fused_ocr_chain(tbp, top, tcls, tner, pages, compact_slots=compact_slots)
    stats, jstats = got[0], want[0]
    for field in ("boxes", "areas", "scores", "valid", "stride"):
        np.testing.assert_array_equal(stats[field].numpy(), np.asarray(jstats[field]),
                                      err_msg=field)
    kept = np.asarray(jstats["valid"]).sum(axis=1)  # ink: every valid box is kept
    assert kept.sum() > 0
    assert kept[0] > seq_cap or seq_cap == 16
    assert kept.sum() > 2 * compact_slots or compact_slots == 4
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=ATOL)
    assert got[3].shape == (2, 3) and got[4].shape == (2, seq_cap)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), atol=ATOL)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    np.testing.assert_allclose(got[5].numpy(), np.asarray(want[5]), atol=ATOL)


def _floats_apart(results):
    """(result dicts without their float scores, the scores in order)."""
    plain, confs, scores = [], [], []
    for r in results:
        words = []
        for w in r["words"]:
            confs.append(w["confidence"])
            scores.append(w.get("ner_score", -1.0))
            words.append(dict(w, confidence=None, ner_score=None))
        for ln in r["lines"]:
            confs.append(ln["confidence"])
        cls = dict(r.get("classification", {}))
        scores.append(cls.pop("score", -1.0))
        plain.append(dict(r, words=words, classification=cls,
                          lines=[dict(ln, confidence=None) for ln in r["lines"]]))
    return plain, np.asarray(confs), np.asarray(scores)


def assert_same_chain_results(got, want):
    g, g_conf, g_scores = _floats_apart(got)
    w, w_conf, w_scores = _floats_apart(want)
    assert g == w
    np.testing.assert_allclose(g_conf, w_conf, rtol=0, atol=CONF_ATOL)
    np.testing.assert_allclose(g_scores, w_scores, rtol=0, atol=ATOL)


@pytest.mark.parametrize("pms_mode", ["sparse", "line"])
@pytest.mark.parametrize("seq_cap,compact_slots,n_words,upload_format,coordinate_format", [
    (16, 4, (2, 3, 4), "u8", "xywh"),  # a 2-page group and a 1-page tail
    (16, 2, (5, 4, 1), "u8", "xywh"),  # rows past each group's budget
    (4, 4, (7, 1, 2), "u8", "xywh"),  # page 0's kept rows pass the sequence cap
    (16, 4, (3, 2, 4), "u2", "xyxy"),  # packed uploads, xyxy boxes
])
def test_engine_extract_with_chained_heads(processors, pms_mode, seq_cap, compact_slots,
                                           n_words, upload_format, coordinate_format):
    """PipelineOcrEngine(classifier=, indexer=) result dicts equal the JAX
    engine's: words, lines, classification label ids and labels, every
    word's NER label id and label (none past the cap)."""
    (jbp, jop), (tbp, top) = processors
    (jcls, jner), (tcls, tner) = _heads(seq_cap)
    pages = [_page(30 + i, n) for i, n in enumerate(n_words)]
    kw = dict(page_fuse_batch=2, compact_slots=compact_slots, upload_format=upload_format)
    want = JaxEngine(jbp, jop, classifier=jcls, indexer=jner, **kw).extract(
        pages, JaxPSMode(pms_mode), JaxCoordinateFormat(coordinate_format))
    got = PipelineOcrEngine(tbp, top, classifier=tcls, indexer=tner, **kw).extract(
        pages, PSMode(pms_mode), CoordinateFormat(coordinate_format))
    assert_same_chain_results(got, want)
    assert len(got) == 3
    for r in got:
        assert r["classification"]["label"] in CLASSES
        assert 0.0 < r["classification"]["score"] <= 1.0
    labelled = [w for r in got for w in r["words"] if "ner_label" in w]
    assert all(w["ner_label"] in NER for w in labelled)
    n = sum(len(r["words"]) for r in got)
    assert n > 0
    if seq_cap < max(n_words):
        assert len(labelled) < n  # words past the cap carry no label
    else:
        assert len(labelled) == n


def test_engine_runs_one_head_alone_without_chain(processors):
    """One head alone is not chained (as in the JAX engine): plain OCR
    results, no classification."""
    _, (tbp, top) = processors
    _, (tcls, _) = _heads(16)
    pages = [_page(40, 2)]
    got = PipelineOcrEngine(tbp, top, classifier=tcls).extract(pages)
    assert got == PipelineOcrEngine(tbp, top).extract(pages)
    assert "classification" not in got[0]
