"""The port's executors against the JAX package's, on the CPU.

* ``TextExtractionExecutor`` built the default way (the registry's
  ``default`` engine on the trained trees, no overlay: the port's zoo has
  no trained generator) on 2 shipped pages, against the JAX executor over
  the same pipeline configuration: the envelopes are equal with the
  elapsed and stage times masked, the work dir in asset paths replaced,
  and word and line confidences within 2e-2, the bf16 serving engine's
  limit (PERF.md §2: one rounding of the logits; measured here: 2e-3 on
  2 of 328, the rest within the schema's 3-decimal rounding).
* ``NerExtractionExecutor`` with the trained ``reading-order-synth``
  tree and a tiny LayoutLM indexer from one numpy tree: equal entities
  (scores within 1e-5) and equal sqlite storage rows (ids and times
  masked).
* The classifier, overlay and template-matching executors on seeded
  inputs, with each component's tolerance from its own test file.
"""

import dataclasses
import json
import os
import sqlite3

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from marie_tpu.types.docs import Document as JDocument
from marie_tpu.types.docs import DocumentArray as JDocumentArray
from marie_tpu_torch.registry.zoo import ZOO_DIR, open_zoo_json
from marie_tpu_torch.types.docs import Document, DocumentArray

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF_ATOL = 2e-2  # the bf16 recogniser's limit
ENTITY_ATOL = 1e-5
MATCH_ATOL = 2e-4  # the matchers' 1e-4, plus the envelope's 4-decimal rounding


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def shipped():
    with np.load(os.path.join(ZOO_DIR, "pages.npz")) as data:
        pages = data["pages"][:2].copy()
    with open_zoo_json("golden") as f:
        golden = json.load(f)["pages"][:2]
    return pages, golden


def _pop_confidences(envelope):
    """Word and line confidences of an extract envelope, taken out."""
    out = []
    for page in envelope["metadata"]["ocr"]:
        for item in page["words"] + page["lines"]:
            out.append(item.pop("confidence"))
    return np.asarray(out)


def test_text_extraction_executor_matches_jax(shipped, tmp_path):
    from marie_tpu.executor import TextExtractionExecutor as JExecutor
    from marie_tpu.ocr.util import get_known_ocr_engines
    from marie_tpu.pipe.extract_pipeline import ExtractPipeline as JPipeline
    from marie_tpu_torch.executor import TextExtractionExecutor

    pages, _ = shipped
    port = TextExtractionExecutor(device="cpu", work_dir=str(tmp_path / "port"))
    assert port.pipeline.overlay_processor is None
    assert all(port.pipeline.ocr_engine.trained.values())
    ref = JExecutor(pipeline=JPipeline(
        ocr_engine=get_known_ocr_engines(engine="default")["default"],
        work_dir=str(tmp_path / "jax"), overlay_processor=None))
    params = {"ref_id": "doc-1", "ref_type": "invoice", "job_id": "job-1"}
    got = port.extract(DocumentArray([Document(id="a", tensor=p) for p in pages]), params)
    want = ref.extract(JDocumentArray([JDocument(id="a", tensor=p) for p in pages]), params)
    assert got["status"] == "succeeded", got.get("error")
    for env, root in ((got, "port"), (want, "jax")):
        env["runtime_info"]["elapsed"] = None
        env["metadata"]["stage_times_s"] = None
        env["metadata"]["assets"] = [a.replace(str(tmp_path / root), "<work>")
                                     for a in env["metadata"]["assets"]]
    np.testing.assert_allclose(_pop_confidences(got), _pop_confidences(want), rtol=0,
                               atol=CONF_ATOL)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert sum(len(p["words"]) for p in got["metadata"]["ocr"]) > 200

    empty = (port.extract(DocumentArray([Document(text="no pixels")]), {}),
             ref.extract(JDocumentArray([JDocument(text="no pixels")]), {}))
    assert empty[0] == empty[1] == {"status": "failed", "error": "no frames in request"}
    status = port.info(DocumentArray())
    assert status["status"] == "OK" and "torch" in status["runtime_info"]


def _ner_docs(cls, golden, pages):
    """Page 0 with its image (the page span scales the reading order),
    page 1 without (the boxes' span does)."""
    out = []
    for i, page in enumerate(golden):
        words = [w["text"] for w in page["words"]]
        boxes = [w["box"] for w in page["words"]]
        out.append(cls(id=f"n{i}", tensor=pages[i] if i == 0 else None,
                       tags={"words": words, "boxes": boxes}))
    return out


def _rows(path):
    con = sqlite3.connect(path)
    rows = con.execute("SELECT ref_id, ref_type, store_mode, tags, content FROM ner "
                       "ORDER BY ref_id").fetchall()
    con.close()
    return rows


def test_ner_executor_matches_jax(shipped, tmp_path):
    from marie_tpu.components.document_indexer import LayoutDocumentIndexer as JIndexer
    from marie_tpu.executor import NerExtractionExecutor as JExecutor
    from marie_tpu.models import configs as jcfg
    from marie_tpu.registry.zoo import zoo_params as jax_zoo_params
    from marie_tpu_torch.components.document_indexer import LayoutDocumentIndexer
    from marie_tpu_torch.executor import NerExtractionExecutor
    from marie_tpu_torch.executor.ner_executor import reading_order_boxes
    from marie_tpu_torch.models import configs as tcfg
    from marie_tpu_torch.models.reading_order import ReadingOrderConfig, TextLayout
    from marie_tpu_torch.registry.convert import init_flax_layout
    from tests.test_torch_layoutlm import assert_close_tree

    pages, golden = shipped
    labels = ("O", "B-KEY", "I-KEY", "B-VALUE", "I-VALUE")
    jc = dataclasses.replace(jcfg.LayoutLMConfig.tiny(len(labels)), use_image=False,
                             max_seq_len=64)
    tc = dataclasses.replace(tcfg.LayoutLMConfig.tiny(len(labels)), use_image=False,
                             max_seq_len=64)
    tree = init_flax_layout(tc, 31, "token")
    ro_tree = jax.device_get(jax_zoo_params("reading-order-synth"))
    layout = TextLayout(ReadingOrderConfig.base(), ro_tree, device="cpu")
    conf = {"provider": "sqlite", "default_table": "ner"}
    port = NerExtractionExecutor(
        indexer=LayoutDocumentIndexer(labels, tc, tree, stride=32, device="cpu"),
        reading_order=False, storage_enabled=True,
        storage_conf={**conf, "path": str(tmp_path / "port.db")}, device="cpu")
    port.text_layout = layout
    ref = JExecutor(indexer=JIndexer(labels, jc, _jnp(tree), stride=32), reading_order=True,
                    storage_enabled=True, storage_conf={**conf, "path": str(tmp_path / "jax.db")})
    assert ref.text_layout is not None and port.storage_enabled
    params = {"ref_id": "doc-9", "ref_type": "claim"}
    tdocs = DocumentArray(_ner_docs(Document, golden, pages))
    jdocs = JDocumentArray(_ner_docs(JDocument, golden, pages))
    got = port.extract(tdocs, params)
    want = ref.extract(jdocs, params)
    assert got["status"] == want["status"] == "succeeded"
    assert_close_tree(got["entities"], want["entities"], atol=ENTITY_ATOL)
    assert sum(len(r["entities"]) for r in got["entities"]) > 0
    assert_close_tree([d.tags["indexer"] for d in tdocs], [d.tags["indexer"] for d in jdocs],
                      atol=ENTITY_ATOL)
    rows, jrows = _rows(str(tmp_path / "port.db")), _rows(str(tmp_path / "jax.db"))
    assert len(rows) == len(jrows) == 1
    assert rows[0][:4] == jrows[0][:4]
    assert_close_tree(json.loads(rows[0][4]), json.loads(jrows[0][4]), atol=ENTITY_ATOL)
    # the reading order the executor applied moved words on both pages
    for doc, page in zip(tdocs, golden):
        xyxy, scale = reading_order_boxes(doc.tags["boxes"], doc.tensor)
        assert layout.order(xyxy, scale=scale) != list(range(len(xyxy)))


def test_classifier_executor_matches_jax(shipped):
    from marie_tpu.components.document_classifier import LayoutDocumentClassifier as JCls
    from marie_tpu.executor import DocumentClassificationExecutor as JExecutor
    from marie_tpu.models import configs as jcfg
    from marie_tpu_torch.components.document_classifier import LayoutDocumentClassifier
    from marie_tpu_torch.executor import DocumentClassificationExecutor
    from marie_tpu_torch.models import configs as tcfg
    from marie_tpu_torch.registry.convert import init_flax_layout
    from tests.test_torch_layoutlm import assert_close_tree

    pages, golden = shipped
    labels = ("a", "b", "c")
    jc = dataclasses.replace(jcfg.LayoutLMConfig.tiny(3), max_seq_len=64)
    tc = dataclasses.replace(tcfg.LayoutLMConfig.tiny(3), max_seq_len=64)
    tree = init_flax_layout(tc, 33, "sequence")
    port = DocumentClassificationExecutor(
        classifier=LayoutDocumentClassifier(labels, tc, tree, device="cpu"))
    ref = JExecutor(classifier=JCls(labels, jc, _jnp(tree)))

    def docs(cls):
        return [cls(id=f"c{i}", tensor=pages[i],
                    tags={"words": [w["text"] for w in g["words"]],
                          "boxes": [w["box"] for w in g["words"]]})
                for i, g in enumerate(golden)]

    tdocs, jdocs = DocumentArray(docs(Document)), JDocumentArray(docs(JDocument))
    got, want = port.classify(tdocs, {}), ref.classify(jdocs, {})
    assert_close_tree(got, want, atol=ENTITY_ATOL)
    assert [d.tags["classification"]["label"] for d in tdocs] == [
        d.tags["classification"]["label"] for d in jdocs]


def test_overlay_executor_matches_jax():
    """The trained generator (``model_zoo/pix2pix-synth``) cleans a dirty
    page: masks equal on >= 99.95%, pages equal on >= 99.9% and never
    more than 1 apart where the masks agree (the rule of
    ``tests/test_torch_overlay.py``)."""
    from marie_tpu.executor import OverlayExecutor as JExecutor
    from marie_tpu.models.configs import Pix2PixConfig as JaxPix2PixConfig
    from marie_tpu.overlay import OverlayProcessor as JaxOverlay
    from marie_tpu.registry.checkpoints import load_params
    from marie_tpu.train.overlay import render_overlay_pair
    from marie_tpu_torch.executor import OverlayExecutor
    from marie_tpu_torch.models.configs import Pix2PixConfig
    from marie_tpu_torch.overlay import OverlayProcessor

    tree = jax.device_get(load_params(os.path.join(REPO, "model_zoo", "pix2pix-synth")))
    port = OverlayExecutor(overlay_processor=OverlayProcessor(
        config=Pix2PixConfig.synth(), variables=tree, device="cpu"))
    ref = JExecutor(overlay_processor=JaxOverlay(config=JaxPix2PixConfig.synth(),
                                                 variables=_jnp(tree)))
    page = render_overlay_pair(np.random.default_rng(5), (256, 192))[1].mean(-1).astype(np.uint8)
    tdocs = port.segment(DocumentArray([Document(id="o", tensor=page), Document(id="e")]), {})
    jdocs = ref.segment(JDocumentArray([JDocument(id="o", tensor=page), JDocument(id="e")]), {})
    got, want = tdocs[0].tensor, jdocs[0].tensor
    assert got.shape == want.shape == page.shape + (3,) and tdocs[1].tensor is None
    d = np.abs(got.astype(np.int16) - want)
    assert np.mean(d == 0) >= 0.999 and d.max() <= 1
    # the masks (0 or 255) differ on at most 0.05% of pixels
    assert abs(tdocs[0].tags["overlay_mask_mean"]
               - jdocs[0].tags["overlay_mask_mean"]) <= (1 - 0.9995) * 255


def test_template_matching_executor_matches_jax():
    """NCC: three word snippets of shipped page 0 and a noise template,
    registered (one through a ``bbox`` selector) and matched on two crops
    of the page: equal labels and boxes, scores within MATCH_ATOL."""
    from marie_tpu.executor import TemplateMatchingExecutor as JExecutor
    from marie_tpu_torch.executor import TemplateMatchingExecutor

    with np.load(os.path.join(ZOO_DIR, "pages.npz")) as data:
        page = np.ascontiguousarray(data["pages"][0])
    with open_zoo_json("truth") as f:
        truth = json.load(f)["pages"][0]
    port = TemplateMatchingExecutor(matcher_name="ncc", device="cpu")
    ref = JExecutor(matcher_name="ncc")

    def templates(cls):
        out = [cls(id=f"t{k}", tensor=page[y:y + h, x:x + w], tags={"label": text})
               for k, (text, (x, y, w, h)) in enumerate(truth[:2])]
        text, (x, y, w, h) = truth[2]
        out.append(cls(id="t2", tensor=page, tags={"label": text, "bbox": [x, y, w, h]}))
        noise = (np.random.default_rng(3).random((20, 40)) * 255).astype(np.uint8)
        out.append(cls(id="t3", tensor=noise))
        return out

    reg = (port.register(DocumentArray(templates(Document)), {}),
           ref.register(JDocumentArray(templates(JDocument)), {}))
    assert reg[0] == reg[1] and reg[0]["total_templates"] == 4
    frames = [page[:256, :320], page[100:356, :320]]
    params = {"score_threshold": 0.8, "max_matches_per_template": 3}
    tdocs = DocumentArray([Document(id=f"f{i}", tensor=f) for i, f in enumerate(frames)]
                          + [Document(id="none")])
    jdocs = JDocumentArray([JDocument(id=f"f{i}", tensor=f) for i, f in enumerate(frames)]
                           + [JDocument(id="none")])
    got, want = port.match(tdocs, params), ref.match(jdocs, params)
    assert got["status"] == want["status"] == "succeeded" and got["matches"]

    def keyed(ms):
        return sorted(ms, key=lambda m: (m["frame_index"], m["label"], m["bbox"]))

    g, w = keyed(got["matches"]), keyed(want["matches"])
    assert [(m["frame_index"], m["label"], m["bbox"]) for m in g] == [
        (m["frame_index"], m["label"], m["bbox"]) for m in w]
    for a, b in zip(g, w):
        assert abs(a["score"] - b["score"]) <= MATCH_ATOL
        assert abs(a["similarity"] - b["similarity"]) <= MATCH_ATOL
    assert [len(d.tags["matches"]) for d in tdocs] == [len(d.tags["matches"]) for d in jdocs]
    assert port.match(DocumentArray([Document(id="x")]), {}) == \
        ref.match(JDocumentArray([JDocument(id="x")]), {})
