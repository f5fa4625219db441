#!/usr/bin/env python
"""Write ``torch_zoo/``: the trained trees, pages with truth, and the JAX
engine's golden results that the PyTorch port (``marie_tpu_torch``) is
checked against where there is no JAX.

Run from the repository root on a machine with JAX, orbax, PIL, cv2 and
the DejaVu font (the JAX package's own environment)::

    python scripts/export_torch_zoo.py          # the serving trees
    python scripts/export_torch_zoo.py --all    # + the -synth heads
    python scripts/export_torch_zoo.py --best   # only crnn-synth.npz and
                                                # golden_best.json
    python scripts/export_torch_zoo.py --classify  # only golden_classify.json
    python scripts/export_torch_zoo.py --extract   # only golden_extract.json
    python scripts/export_torch_zoo.py --register  # only golden_register.json
    python scripts/export_torch_zoo.py --detectors  # only golden_detectors.json
    python scripts/export_torch_zoo.py --reading-order  # only golden_reading_order.json
    python scripts/export_torch_zoo.py --train  # only golden_train.json

It writes

* ``<name>.npz``: each ``model_zoo/<name>`` orbax tree in the port's
  ``.npz`` layout (``marie_tpu_torch/registry/checkpoints.py``).  CRAFT
  and TrOCR are stored as bfloat16, which loses nothing for serving:
  both JAX processors cast every float leaf to bfloat16 at load with
  ``param_dtype="bfloat16"``.  The LayoutLM heads keep float32.
* ``pages.npz``: 16 grayscale 1024x768 pages of ``bench.py::make_pages``
  (``pages``), one RGB page with a tinted background and coloured ink
  made from page 1 (``rgb``), and one 3300x2550 (US letter at 300 dpi)
  grayscale page holding page 0 scaled up by 1.66 (``oversize``), which
  the engine scales down by ~0.602 into its largest bucket.
* ``truth.json``: each page's words as ``[text, [x, y, w, h]]``.
* ``golden.json``: the JAX engine's result dicts for the 16 pages (one
  16-page group), each form, one region request on page 2 and one
  RAW_LINE, WORD and MULTI_LINE request on snippets of page 3, with the
  settings of ``bench.py``'s serving engine and the chained heads:
  heatmap CRAFT (``text_threshold`` 0.6, ``low_text`` 0.4,
  ``max_components`` 256, ``MARIE_CC_RUNS`` 32), greedy TrOCR,
  bfloat16, ``compact_slots`` 160, u2 uploads, page groups of 16, the
  default page buckets.  The processors are built from the ``.npz``
  trees just written, so the golden and the port start from the same
  bits.
* ``golden_classify.json``: the JAX ``ClassificationPipeline`` on the 16
  pages with ``ocr_results`` taken from ``golden.json`` (no OCR): page
  labels and scores, the split and the documents, with a classifier at
  ``LayoutLMConfig.base(num_labels=3)`` (image branch on) and a
  ``LayoutDocumentSplitter(config=LayoutLMConfig.base(2))``, whose trees
  are the port's ``init_flax_layout`` at the seeds the file states; and
  ``LayoutEmbeddingsModel`` at base width (its encoder tree likewise) on
  the first 4 pages' texts (golden words joined by spaces), rounded to 6
  decimals.  The file stays under 100 KB.
* ``golden_extract.json``: the JAX ``ExtractPipeline`` on the 16 pages
  with an engine that replays ``golden.json``'s OCR results
  (``chip_smoke.py::ReplayOcr``), no overlay, all four renderers, the
  classifier of ``golden_classify.json`` and a
  ``LayoutDocumentIndexer`` at ``LayoutLMConfig.base(5)`` (both from the
  port's ``init_flax_layout`` at the seeds the file states): the page
  labels, scores and entities, and ``chip_smoke.py::asset_digest`` of the
  asset directory (renderer hashes and the listing); and the JAX
  ``OverlayProcessor`` at ``Pix2PixConfig()`` (the port's seeded tree) in
  float32 ``segment_batch`` (``gan_scale`` 2) on pages 12-15 made dirty
  by ``chip_smoke.py::dirty_pages``: per page the mask pixels, the
  blended pixels that differ from the input and the blended page's sum.
* ``golden_register.json`` (~4 min): the JAX boundary registration and
  template matchers on the ``register`` phase's inputs, which
  ``chip_smoke.py`` makes with the port from the shipped pages and a
  seed: the deskew path on the 16 pages rotated by known angles (angle,
  box, score and the input and aligned pages' sums); the model path
  (``BoundaryConfig()`` from the port's ``init_flax_layout``) on 4
  scanner canvases, with and without the edge snap (the network's
  normalised corners, the snap, box, angle, score, sums); NCC, DIM, VQNNF
  (``CraftConfig.base()`` likewise) and their composite on the 16 pages
  with 4 word crops and a noise template; and on the pages of
  ``golden_extract.json``'s dirty set registered by the deskew path: the
  boundary metadata, NCC, DIM, VQNNF and their composite, and the serving
  engine's words.  No pixels.
* ``golden_detectors.json`` (~3 min): the other word detectors on the
  shipped pages.  The JAX engine over the weight-free ``InkBoxProcessor``
  and the trained TrOCR of ``golden.json`` on the 16 pages (each word's
  text, box and confidence); ``BoxProcessorUlimDit`` at
  ``ViTConfig.dit_synth_s1()`` on ``chip_smoke.DIT_PAGES`` and at the
  configuration it builds without a tree on ``DIT_DEFAULT_PAGES``, and
  ``BoxProcessorTextFuseNet`` at ``TextFuseNetConfig.synth_s2()`` on
  ``TFN_PAGES``, each from the port's ``init_flax_layout`` at the seeds of
  ``chip_smoke.DETECTOR_SEEDS`` (the trained trees are not shipped): the
  16x16 block means of the heatmaps (TextFuseNet: word, char and seg
  maps), the thresholds used (the defaults where they give boxes, else
  quantiles of the pooled maps, and where those give none either, the
  least ``min_area``), ``detect_words``' boxes and scores, and
  TextFuseNet's fused scores and refined boxes on its valid slots.  No
  pixels and no trees.
* ``golden_reading_order.json`` (~10 s): the JAX ``TextLayout`` at
  ``ReadingOrderConfig.base()`` with the port's ``init_flax_layout`` tree
  at ``chip_smoke.READING_ORDER_SEED`` (the trained
  ``reading-order-synth`` is not shipped) on the golden OCR words of the
  16 pages (``layoutreader.page_word_boxes``) and on the 600-word page of
  ``chip_smoke.long_page_boxes`` (three bands): each order and each box's
  score (9 significant digits, which give the float32 back); and the
  sha256 of what PIL makes of the shipped pages for the ``runtime``
  phase: its quality-80 JPEG of page 0 and of the RGB form (the bytes,
  and their decode), and its G4 strips of page 0 and of the 3300x2550
  page thresholded at 128 (the strips joined, and the strips' count).
* ``golden_train.json`` (~2 min): the held-out figures of the JAX-trained
  trees of ``model_zoo/`` on the held-out sets that the port's trainers
  draw at ``chip_smoke.py``'s ``train`` settings (the seed and dataset
  size of ``scripts/train_splitter.py``, ``train_chain_heads.py`` and
  ``train_reading_order.py``; the port's generators equal JAX's to the
  bit): ``layout-splitter-synth``'s page and split accuracy,
  ``layout-classifier-chain``'s accuracy, ``layout-indexer-chain``'s
  token accuracy, and ``reading-order-synth``'s mean Kendall tau and pair
  accuracy over ``evaluate_reading_order``'s pages.  The ``train`` phase
  holds the card-trained heads to these less 0.03.  Its ``ocr`` entry
  holds the OCR trees of ``torch_zoo/`` (the serving ``.npz``) on the
  JAX package's held-out renders, drawn by PIL (``chip_smoke.py``'s
  ``ocr_train`` settings): ``trocr-fast3g2d6ov-synth``'s and
  ``crnn-synth``'s CER on 512 clean crops and ``craft-s2d2-synth``'s
  weighted MSE on 32 pages.  Its ``boundary`` entry holds
  ``model_zoo/boundary-synth`` to the JAX ``evaluate_boundary`` (64
  scans, seed 777, the trainer's own held-out seed): the yardstick of the
  ``ocr_train`` phase's boundary run.

The JSON files are gzipped (``<name>.json.gz``, no file name or time
stamp in the header: ``_write_json``); ``registry/zoo.py::open_zoo_json``
reads them.  The glyph atlas ``glyphs.npz`` comes from
``scripts/export_glyph_atlas.py``.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.environ["MARIE_CC_RUNS"] = "32"  # read by the JAX detector while it traces

import numpy as np  # noqa: E402

ZOO = os.path.join(REPO, "torch_zoo")
from marie_tpu_torch.registry.zoo import open_zoo_json, zoo_json_path  # noqa: E402
#: (tree, storage dtype) of the serving engine, and the rest with --all
SERVING_TREES = (
    ("craft-s2d2-synth", "bfloat16"),
    ("trocr-fast3g2d6ov-synth", "bfloat16"),
    ("layout-classifier-chain", None),
    ("layout-indexer-chain", None),
)
#: the tree the best engine adds to the serving ones
BEST_TREES = (("crnn-synth", None),)
#: shipped pages in golden_best.json (the JAX beam-5 decode on a CPU
#: takes ~10 s a page)
BEST_PAGES = 16
OTHER_TREES = (
    ("layout-classifier-synth", None),
    ("layout-indexer-synth", None),
    ("layout-splitter-synth", None),
)
PAGE_SEED = 7  # bench.py's timed pages
N_PAGES = 16
OVERSIZE_HW = (3300, 2550)
PAPER_RGB = (250, 243, 226)
INK_RGB = (25, 30, 85)


def export_trees(names) -> None:
    import jax

    from marie_tpu.registry.checkpoints import load_params as load_orbax
    from marie_tpu_torch.registry.checkpoints import save_params

    for name, dtype in names:
        tree = jax.device_get(load_orbax(os.path.join(REPO, "model_zoo", name)))
        path = os.path.join(ZOO, f"{name}.npz")
        save_params(tree, path, dtype=dtype)
        print(f"{name}: {os.path.getsize(path) / 1e6:.1f} MB ({dtype or 'float32'})",
              flush=True)


def make_forms(pages, truths):
    """(rgb page, its truth), (oversize page, its truth)."""
    import cv2

    gray = pages[1].astype(np.float32) / 255.0
    paper = np.asarray(PAPER_RGB, np.float32)
    ink = np.asarray(INK_RGB, np.float32)
    rgb = np.rint(ink + (paper - ink) * gray[..., None]).astype(np.uint8)

    # page 0 scaled up by 1 / 0.602 at the top left of a white letter
    # page: the engine's downscale brings its words back to their size
    h, w = pages[0].shape
    oh, ow = OVERSIZE_HW
    factor = max(oh / 2048, ow / 1536)
    up = cv2.resize(pages[0], (round(w * factor), round(h * factor)),
                    interpolation=cv2.INTER_LINEAR)
    oversize = np.full((oh, ow), 255, np.uint8)
    oversize[:up.shape[0], :up.shape[1]] = up
    truth = [(text, [round(v * factor) for v in box]) for text, box in truths[0]]
    return (rgb, truths[1]), (oversize, truth)


def _union(boxes, pad: int = 6):
    x0 = min(b[0] for b in boxes) - pad
    y0 = min(b[1] for b in boxes) - pad
    x1 = max(b[0] + b[2] for b in boxes) + pad
    y1 = max(b[1] + b[3] for b in boxes) + pad
    return [int(x0), int(y0), int(x1 - x0), int(y1 - y0)]


def _lines(truth):
    """Truth words grouped into lines by their top edge."""
    lines = []
    for text, box in truth:
        if lines and abs(lines[-1][-1][1][1] - box[1]) < 8:
            lines[-1].append((text, box))
        else:
            lines.append([(text, box)])
    return lines


def _column_block(lines, start: int):
    """The first words of three lines from ``start`` on, cut left of each
    line's second word: (xywh box, index of its first line)."""
    for i in range(start, len(lines) - 2):
        trio = lines[i:i + 3]
        if any(len(ln) < 2 for ln in trio):
            continue
        x1 = min(ln[1][1][0] for ln in trio) - 3
        if x1 >= max(ln[0][1][0] + ln[0][1][2] for ln in trio) + 2:
            box = _union([ln[0][1] for ln in trio])
            return [box[0], box[1], x1 - box[0], box[3]], i
    raise ValueError("no three lines whose first words stand in a column")


def make_requests(truths):
    """One region request on page 2 (a word as RAW_LINE, the default; a
    word as WORD; three lines' first words as MULTI_LINE; four full
    lines as SPARSE) and a snippet per mode on page 3:
    {"regions": [...], "modes": {mode: {"page", "box"}}}."""
    lines = _lines(truths[2])
    block, _ = _column_block(lines, 2)
    regions = [
        {"id": "line", "pageIndex": 2, **_xywh(_union([lines[0][0][1]]))},
        {"id": "word", "pageIndex": 2, "mode": "word", **_xywh(_union([lines[1][1][1]]))},
        {"id": "block", "pageIndex": 2, "mode": "multiline", **_xywh(block)},
        {"id": "sparse", "pageIndex": 2, "mode": "sparse",
         **_xywh(_union([b for ln in lines[8:12] for _, b in ln]))},
    ]
    lines = _lines(truths[3])
    modes = {
        "raw_line": _union([lines[0][0][1]]),
        "word": _union([lines[1][1][1]]),
        "multiline": _column_block(lines, 2)[0],
    }
    return {"regions": regions, "modes": {m: {"page": 3, "box": b} for m, b in modes.items()}}


def _xywh(box):
    return dict(zip(("x", "y", "w", "h"), box))


def serving_engine():
    """The JAX serving engine of bench.py with the chained heads, built
    from the .npz trees."""
    from marie_tpu.boxes.craft_box_processor import BoxProcessorCraft
    from marie_tpu.components.document_classifier.layoutlm_classifier import (
        SYNTH_CLASS_LABELS, LayoutDocumentClassifier)
    from marie_tpu.components.document_indexer.layoutlm_indexer import (
        SYNTH_NER_LABELS, LayoutDocumentIndexer)
    from marie_tpu.components.word_tokenizer import RollingWordTokenizer
    from marie_tpu.document.trocr_ocr_processor import TrOcrProcessor
    from marie_tpu.models.configs import CraftConfig, LayoutLMConfig, TrOCRConfig
    from marie_tpu.ocr.ocr_engine import PipelineOcrEngine
    from marie_tpu_torch.registry.checkpoints import load_params

    def tree(name):
        return load_params(os.path.join(ZOO, f"{name}.npz"))

    box = BoxProcessorCraft(
        config=CraftConfig.fast_s2d2(), variables=tree("craft-s2d2-synth"),
        box_source="heatmap", text_threshold=0.6, low_text=0.4,
        max_components=256, param_dtype="bfloat16")
    icr = TrOcrProcessor(
        config=TrOCRConfig.fast_v3_g2_d6(), params=tree("trocr-fast3g2d6ov-synth"),
        beam_size=1, param_dtype="bfloat16", batch_sizes=(32, 128, 256))

    def head(cls, name, labels):
        config = dataclasses.replace(LayoutLMConfig.synth(num_labels=len(labels)),
                                     max_seq_len=192)
        return cls(labels=labels, config=config, params=tree(name),
                   tokenizer=RollingWordTokenizer(config.vocab_size))

    return PipelineOcrEngine(
        box, icr, upload_format="u2", compact_slots=160, page_fuse_batch=16,
        classifier=head(LayoutDocumentClassifier, "layout-classifier-chain",
                        SYNTH_CLASS_LABELS),
        indexer=head(LayoutDocumentIndexer, "layout-indexer-chain", SYNTH_NER_LABELS))


def best_engine():
    """The JAX ``best`` engine of ``ocr/util.py`` built from the .npz
    trees: heatmap CRAFT (``text_threshold`` 0.6, ``low_text`` 0.4,
    ``max_components`` 384, bfloat16) voting TrOCR beam-5 (bfloat16)
    with the CRNN (float32)."""
    from marie_tpu.boxes.craft_box_processor import BoxProcessorCraft
    from marie_tpu.document.crnn_ocr_processor import CrnnOcrProcessor
    from marie_tpu.document.trocr_ocr_processor import TrOcrProcessor
    from marie_tpu.models.configs import CraftConfig, TrOCRConfig
    from marie_tpu.ocr.voting_ocr_engine import VotingOcrEngine
    from marie_tpu_torch.registry.checkpoints import load_params

    def tree(name):
        return load_params(os.path.join(ZOO, f"{name}.npz"))

    box = BoxProcessorCraft(
        config=CraftConfig.fast_s2d2(), variables=tree("craft-s2d2-synth"),
        box_source="heatmap", text_threshold=0.6, low_text=0.4, link_threshold=0.4,
        max_components=384, param_dtype="bfloat16")
    trocr = TrOcrProcessor(config=TrOCRConfig.fast_v3_g2_d6(),
                           params=tree("trocr-fast3g2d6ov-synth"), beam_size=5,
                           param_dtype="bfloat16")
    crnn = CrnnOcrProcessor(variables=tree("crnn-synth"))
    return VotingOcrEngine(box_processor=box, ocr_processors=[trocr, crnn])


def export_best() -> None:
    """crnn-synth.npz and golden_best.json, from the shipped pages."""
    from marie_tpu.enums import PSMode

    export_trees(BEST_TREES)
    with np.load(os.path.join(ZOO, "pages.npz")) as data:
        stack = data["pages"]
    with open_zoo_json("truth") as f:
        truths = json.load(f)["pages"]
    spec = make_requests(truths)["modes"]["word"]
    # the registry's CC run budget (read while the detector traces)
    os.environ["MARIE_CC_RUNS"] = "48"
    engine = best_engine()
    t0 = time.time()
    golden = {
        "settings": {
            "detector": "craft-s2d2-synth heatmap, text_threshold 0.6, low_text 0.4, "
                        "max_components 384, cc_runs 48, bfloat16",
            "recognizers": "trocr-fast3g2d6ov-synth beam 5, bfloat16, batch sizes "
                           "8/32/128; crnn-synth float32, widths 64/128/256; "
                           "word-level vote",
            "engine": "VotingOcrEngine, SPARSE, one detect_dispatch per page",
            "pages": f"the first {BEST_PAGES} of pages.npz",
        },
        "pages": engine.extract(list(stack[:BEST_PAGES])),
        "word": dict(spec, result=engine.extract(
            [_cut(stack[spec["page"]], spec["box"])], PSMode.WORD)[0]),
    }
    print(f"golden_best: {time.time() - t0:.1f} s", flush=True)
    _write_json("golden_best", golden, default=_json_default, separators=(",", ":"))


#: (seed, config) of the trees in golden_classify.json; the classifier's
#: seed is the one chip_smoke.py's layoutlm_base phase draws its
#: base-width classifier from
CLASSIFY_SEEDS = {"classifier": 10, "splitter": 30, "embeddings": 31}
CLASSIFY_LABELS = ("invoice", "correspondence", "claim")
EMBED_PAGES = 4


def page_texts(pages):
    """Each result dict's words joined by single spaces."""
    return [" ".join(w["text"] for w in page["words"]) for page in pages]


def export_classify() -> None:
    """golden_classify.json, from the shipped pages and golden.json."""
    import tempfile

    import jax
    import jax.numpy as jnp

    from marie_tpu.components.document_classifier import LayoutDocumentClassifier
    from marie_tpu.components.document_splitter import LayoutDocumentSplitter
    from marie_tpu.embeddings import LayoutEmbeddingsModel
    from marie_tpu.models.configs import LayoutLMConfig
    from marie_tpu.pipe import ClassificationPipeline
    from marie_tpu_torch.models.configs import LayoutLMConfig as PortConfig
    from marie_tpu_torch.registry.convert import init_flax_layout

    def tree(config, seed, head):
        return jax.tree_util.tree_map(jnp.asarray, init_flax_layout(config, seed, head))

    with np.load(os.path.join(ZOO, "pages.npz")) as data:
        stack = data["pages"]
    with open_zoo_json("golden") as f:
        ocr = json.load(f)["pages"]
    seeds = CLASSIFY_SEEDS
    t0 = time.time()
    classifier = LayoutDocumentClassifier(
        labels=CLASSIFY_LABELS, config=LayoutLMConfig.base(num_labels=3),
        params=tree(PortConfig.base(num_labels=3), seeds["classifier"], "sequence"))
    splitter = LayoutDocumentSplitter(
        config=LayoutLMConfig.base(2),
        params=tree(PortConfig.base(2), seeds["splitter"], "sequence"))
    with tempfile.TemporaryDirectory() as work_dir:
        meta = ClassificationPipeline(ocr_engine=None, classifiers=[classifier],
                                      splitter=splitter, work_dir=work_dir).execute(
            "shipped", "classify", list(stack), ocr_results=ocr)
    texts = page_texts(ocr[:EMBED_PAGES])
    embed_config = dataclasses.replace(PortConfig.base(), use_image=False)
    vectors = LayoutEmbeddingsModel(
        config=LayoutLMConfig.base(),
        params=tree(embed_config, seeds["embeddings"], "encoder")).get_embeddings(texts)
    golden = {
        "settings": {
            "pipeline": "ClassificationPipeline(ocr_engine=None), ocr_results = golden.json "
                        "pages, frames = pages.npz pages",
            "classifier": "LayoutDocumentClassifier(labels, LayoutLMConfig.base(num_labels=3)),"
                          " use_image, init_flax_layout(config, seed, 'sequence')",
            "splitter": "LayoutDocumentSplitter(config=LayoutLMConfig.base(2)), "
                        "init_flax_layout(config, seed, 'sequence')",
            "embeddings": "LayoutEmbeddingsModel(LayoutLMConfig.base()), use_image False, "
                          "init_flax_layout(config, seed, 'encoder'); texts: the first "
                          f"{EMBED_PAGES} golden pages' words joined by spaces; 6 decimals",
            "seeds": seeds,
            "labels": list(CLASSIFY_LABELS),
        },
        "page_classifier": meta["page_classifier"],
        "splitter": meta["splitter"],
        "documents": meta["documents"],
        "embeddings": np.round(vectors.astype(np.float64), 6).tolist(),
    }
    print(f"golden_classify: {time.time() - t0:.1f} s", flush=True)
    _write_json("golden_classify", golden, default=_json_default, separators=(",", ":"))


#: the indexer of golden_extract.json: chip_smoke.py's layoutlm_base
#: draws its base-width indexer from this seed
EXTRACT_SEEDS = {"classifier": CLASSIFY_SEEDS["classifier"], "indexer": 11, "generator": 0}
NER_LABELS = ("O", "B-KEY", "I-KEY", "B-VALUE", "I-VALUE")


def export_extract() -> None:
    """golden_extract.json, from the shipped pages and golden.json."""
    import tempfile

    import jax
    import jax.numpy as jnp

    from chip_smoke import DIRTY_PAGES, DIRTY_SEED, ReplayOcr, asset_digest, dirty_pages
    from marie_tpu.components.document_classifier import LayoutDocumentClassifier
    from marie_tpu.components.document_indexer import LayoutDocumentIndexer
    from marie_tpu.models.configs import LayoutLMConfig, Pix2PixConfig
    from marie_tpu.overlay.overlay import OverlayProcessor, _segment_batch_gray_jit
    from marie_tpu.pipe import ExtractPipeline
    from marie_tpu_torch.models.configs import LayoutLMConfig as PortConfig
    from marie_tpu_torch.models.configs import Pix2PixConfig as PortPix2Pix
    from marie_tpu_torch.overlay.overlay import SEED as GENERATOR_SEED
    from marie_tpu_torch.registry.convert import init_flax_layout

    def tree(config, seed, head=None):
        return jax.tree_util.tree_map(jnp.asarray, init_flax_layout(config, seed, head))

    assert GENERATOR_SEED == EXTRACT_SEEDS["generator"]
    with np.load(os.path.join(ZOO, "pages.npz")) as data:
        stack = data["pages"]
    with open_zoo_json("golden") as f:
        ocr = json.load(f)["pages"]
    seeds = EXTRACT_SEEDS
    t0 = time.time()
    classifier = LayoutDocumentClassifier(
        labels=CLASSIFY_LABELS, config=LayoutLMConfig.base(num_labels=3),
        params=tree(PortConfig.base(num_labels=3), seeds["classifier"], "sequence"))
    indexer = LayoutDocumentIndexer(
        labels=NER_LABELS, config=LayoutLMConfig.base(num_labels=5),
        params=tree(PortConfig.base(num_labels=5), seeds["indexer"], "token"))
    with tempfile.TemporaryDirectory() as work_dir:
        meta = ExtractPipeline(ocr_engine=ReplayOcr(ocr), classifiers=[classifier],
                               indexers=[indexer], work_dir=work_dir).execute(
            "shipped.tif", "extract", list(stack))
        (checksum,) = os.listdir(work_dir)
        digest = asset_digest(os.path.join(work_dir, checksum))
    print(f"golden_extract pipeline: {time.time() - t0:.1f} s", flush=True)

    t0 = time.time()
    dirty = np.stack(dirty_pages(stack[list(DIRTY_PAGES)], DIRTY_SEED))
    proc = OverlayProcessor(config=Pix2PixConfig(),
                            variables=tree(PortPix2Pix(), seeds["generator"]))
    mask, blended = jax.device_get(_segment_batch_gray_jit(
        proc.model, proc.variables, jnp.asarray(dirty), compute_dtype=jnp.float32, gan_scale=2))
    overlay = [{"page": p, "mask_pixels": int((m > 0).sum()),
                "changed_pixels": int((b != d).sum()), "sum": int(b.astype(np.int64).sum())}
               for p, m, b, d in zip(DIRTY_PAGES, mask, blended, dirty)]
    print(f"golden_extract overlay: {time.time() - t0:.1f} s", flush=True)
    golden = {
        "settings": {
            "pipeline": "ExtractPipeline(ocr_engine=ReplayOcr(golden.json pages), no overlay, "
                        "renderers text/pdf/blobs/adlib), ref_id shipped.tif, frames = "
                        "pages.npz pages",
            "classifier": "LayoutDocumentClassifier(labels, LayoutLMConfig.base(num_labels=3)),"
                          " use_image, init_flax_layout(config, seed, 'sequence')",
            "indexer": "LayoutDocumentIndexer(ner_labels, LayoutLMConfig.base(num_labels=5)), "
                       "init_flax_layout(config, seed, 'token')",
            "overlay": "OverlayProcessor(Pix2PixConfig(), init_flax_layout(config, seed)), "
                       "_segment_batch_gray_jit float32, gan_scale 2, on the dirty pages",
            "dirty_pages": {"pages": list(DIRTY_PAGES), "seed": DIRTY_SEED},
            "seeds": seeds,
            "labels": list(CLASSIFY_LABELS),
            "ner_labels": list(NER_LABELS),
        },
        "page_classifier": meta["page_classifier"],
        "page_indexer": meta["page_indexer"],
        "digest": digest,
        "overlay": overlay,
    }
    _write_json("golden_extract", golden, default=_json_default, separators=(",", ":"))


def export_register() -> None:
    """golden_register.json: the JAX boundary registration and template
    matchers on the ``register`` phase's inputs (``chip_smoke.py``)."""
    import jax
    import jax.numpy as jnp

    import chip_smoke as cs
    from marie_tpu.components.document_registration import boundary as jbd
    from marie_tpu.components.template_matching import (
        BaseTemplateMatcher, CompositeTemplateMatcher, DIMTemplateMatcher, NCCTemplateMatcher,
        TemplateMatchResult, VQNNFTemplateMatcher)
    from marie_tpu.models.configs import BoundaryConfig, CraftConfig
    from marie_tpu_torch.components.document_registration.boundary import SEED as BOUNDARY_SEED
    from marie_tpu_torch.components.template_matching.dim_matcher import SEED as TRUNK_SEED
    from marie_tpu_torch.models.configs import BoundaryConfig as PortBoundary
    from marie_tpu_torch.models.configs import CraftConfig as PortCraft
    from marie_tpu_torch.registry.convert import init_flax_layout

    def tree(config, seed):
        return jax.tree_util.tree_map(jnp.asarray, init_flax_layout(config, seed))

    def page_sum(img):
        return int(np.asarray(img).astype(np.int64).sum())

    class Replay(BaseTemplateMatcher):
        """A child of the composite that answers with given rows."""

        def __init__(self, rows):
            super().__init__()
            self.rows = rows

        def match(self, frames, score_threshold=0.8, **kwargs):
            return [TemplateMatchResult(bbox=list(b), label=lbl, score=sc, similarity=sc,
                                        frame_index=f)
                    for f, lbl, b, sc in self.rows if sc >= score_threshold]

    shipped = cs.load_shipped()
    pages = list(shipped["pages"])
    t0 = time.time()
    deskew = []
    reg = jbd.DocumentBoundaryRegistration(use_model=False)
    for page in cs.skewed_pages(pages, "cpu"):
        pred = reg.register(page)
        deskew.append({"input_sum": page_sum(page), **pred.to_dict(),
                       "aligned_sum": page_sum(pred.aligned)})
    print(f"golden_register deskew: {time.time() - t0:.1f} s", flush=True)

    t0 = time.time()
    btree = tree(PortBoundary(), BOUNDARY_SEED)
    model = {}
    for refine in (True, False):
        reg = jbd.DocumentBoundaryRegistration(model_variables=btree,
                                               model_config=BoundaryConfig(),
                                               edge_refine=refine)
        rows = []
        for scan, quad in cs.scans(pages, "cpu"):
            h, w = scan.shape[:2]
            small = jax.image.resize(jnp.asarray(scan, jnp.float32), (192, 256, 3),
                                     "bilinear") / 255.0
            norm = np.asarray(jax.jit(reg.model.apply)(btree, small[None])[0])
            corners = norm.reshape(4, 2) * np.asarray([w - 1.0, h - 1.0], np.float32)
            snapped = jbd.refine_quad_corners(scan, corners) if refine else corners
            pred = reg.register(scan)
            rows.append({"scan_sum": page_sum(scan), "pred": norm.tolist(),
                         "refined": bool(np.any(snapped != corners)),
                         "corners": np.asarray(snapped).tolist(), **pred.to_dict(),
                         "aligned_sum": page_sum(pred.aligned)})
        model["edge_refine" if refine else "no_refine"] = rows
    print(f"golden_register model: {time.time() - t0:.1f} s", flush=True)

    t0 = time.time()
    templates = cs.register_templates(shipped)
    ctree = tree(PortCraft.base(), TRUNK_SEED)

    def run(matchers, frames):
        out = {}
        for name, m in matchers.items():
            for label, img in templates:
                m.add_template(label, img)
            out[name] = cs.match_rows(m.match(frames))
        out["composite"] = cs.match_rows(CompositeTemplateMatcher(
            [Replay(out[name]) for name in matchers]).match(frames))
        return out

    matching = run({"ncc": NCCTemplateMatcher(),
                    "dim": DIMTemplateMatcher(variables=ctree, config=CraftConfig.base()),
                    "vqnnf": VQNNFTemplateMatcher(variables=ctree, config=CraftConfig.base())},
                   pages)
    print(f"golden_register matching: {time.time() - t0:.1f} s", flush=True)

    t0 = time.time()
    frames = list(pages)
    for i, d in zip(cs.DIRTY_PAGES, cs.dirty_pages([pages[i] for i in cs.DIRTY_PAGES])):
        frames[i] = d
    reg = jbd.DocumentBoundaryRegistration(use_model=False)
    boundary, registered = [], []
    for i, f in enumerate(frames):
        pred = reg.register(f)
        boundary.append({"page": i, **pred.to_dict()})
        registered.append(np.asarray(pred.aligned))
    pipeline = {"boundary": boundary, "aligned_sums": [page_sum(r) for r in registered]}
    pipeline.update(run({"ncc": NCCTemplateMatcher(),
                         "dim": DIMTemplateMatcher(variables=ctree, config=CraftConfig.base()),
                         "vqnnf": VQNNFTemplateMatcher(variables=ctree,
                                                       config=CraftConfig.base())},
                        registered))
    pipeline["ocr"] = [[[w["text"], w["box"]] for w in page["words"]]
                       for page in serving_engine().extract(registered)]
    print(f"golden_register pipeline: {time.time() - t0:.1f} s", flush=True)
    golden = {
        "settings": {
            "deskew": "DocumentBoundaryRegistration(use_model=False) on chip_smoke.skewed_pages "
                      "(the 16 pages rotated by skew_angles)",
            "model": "DocumentBoundaryRegistration(BoundaryNet(BoundaryConfig()), "
                     "init_flax_layout(config, seed)), edge_refine on and off, on "
                     "chip_smoke.scans; pred: the network's normalised corners",
            "matching": "NCC, DIM and VQNNF (CraftConfig.base(), init_flax_layout(config, "
                        "seed)) at their default thresholds on the 16 pages with "
                        "chip_smoke.register_templates; composite: CompositeTemplateMatcher "
                        "of the three at 0.8",
            "pipeline": "the 16 pages with DIRTY_PAGES made dirty, each registered by "
                        "DocumentBoundaryRegistration(use_model=False): the boundary "
                        "metadata, NCC, DIM, VQNNF and their composite on the registered "
                        "pages, and golden.json's serving engine's words on them",
            "seeds": {"boundary": BOUNDARY_SEED, "trunk": TRUNK_SEED,
                      "register": cs.REGISTER_SEED, "dirty": cs.DIRTY_SEED},
        },
        "deskew": deskew,
        "model": model,
        "matching": matching,
        "pipeline": pipeline,
    }
    _write_json("golden_register", golden, default=_json_default, separators=(",", ":"))


def export_detectors() -> None:
    """golden_detectors.json: the JAX ink engine and the seeded DiT and
    TextFuseNet detectors on the ``detectors`` phase's pages."""
    import cv2
    import jax
    import jax.numpy as jnp

    import chip_smoke as cs
    from marie_tpu.boxes.dit_box_processor import BoxProcessorUlimDit
    from marie_tpu.boxes.ink_box_processor import InkBoxProcessor
    from marie_tpu.boxes.textfusenet_box_processor import (
        BoxProcessorTextFuseNet, _tfn_detect_jit)
    from marie_tpu.document.trocr_ocr_processor import TrOcrProcessor
    from marie_tpu.models.configs import TrOCRConfig, ViTConfig
    from marie_tpu.models.textfusenet import TextFuseNetConfig
    from marie_tpu.ocr.ocr_engine import PipelineOcrEngine
    from marie_tpu.preprocess import pad_to
    from marie_tpu.preprocess.ops import normalize_page
    from marie_tpu_torch.boxes.dit_box_processor import DEFAULT_CONFIG
    from marie_tpu_torch.models.configs import TextFuseNetConfig as PortTfn
    from marie_tpu_torch.models.configs import ViTConfig as PortViT
    from marie_tpu_torch.registry.checkpoints import load_params
    from marie_tpu_torch.registry.convert import init_flax_layout

    shipped = cs.load_shipped()
    pages = list(shipped["pages"])
    rgb = [np.stack([p] * 3, axis=-1) for p in pages]

    def tree(config, seed):
        return jax.tree_util.tree_map(jnp.asarray, init_flax_layout(config, seed))

    def padded(bp, img):
        h, w = img.shape[:2]
        (bh, bw), scale = bp.buckets.fit_with_scale(h, w)
        if scale < 1.0:
            img = cv2.resize(img, (int(w * scale), int(h * scale)),
                             interpolation=cv2.INTER_AREA)
        return jnp.asarray(pad_to(img, bh, bw))

    t0 = time.time()
    icr = TrOcrProcessor(config=TrOCRConfig.fast_v3_g2_d6(),
                         params=load_params(os.path.join(ZOO, "trocr-fast3g2d6ov-synth.npz")),
                         beam_size=1, param_dtype="bfloat16", batch_sizes=(32, 128, 256))
    ink = [[[w["text"], w["box"], w["confidence"]] for w in r["words"]]
           for r in PipelineOcrEngine(InkBoxProcessor(), icr).extract(pages)]
    print(f"golden_detectors ink: {time.time() - t0:.1f} s", flush=True)

    def detections(bp, ids):
        return [bp.detect_words(rgb[i]) for i in ids]

    def dit(name, config, ids):
        t0 = time.time()
        kw = dataclasses.asdict(config)
        kw["image_size"] = tuple(kw["image_size"])
        bp = BoxProcessorUlimDit(config=ViTConfig(**kw),
                                 variables=tree(config, cs.DETECTOR_SEEDS[name]))
        apply = jax.jit(bp.model.apply)
        heats = [np.asarray(apply(bp.variables, normalize_page(padded(bp, rgb[i]))[None])[0])
                 for i in ids]
        found = detections(bp, ids)
        rule = "defaults"
        if not any(len(b) for b, _ in found):
            rule = "quantiles 0.90 / 0.95 of the pooled region maps"
            bp.low_text, bp.text_threshold = cs.detector_thresholds(
                [h[..., 0] for h in heats], (0.90, 0.95))
            found = detections(bp, ids)
        if not any(len(b) for b, _ in found):
            # a seeded sub-pixel head's phases never touch: one-pixel parts
            rule += ", min_area 1"
            bp.min_area = 1
            found = detections(bp, ids)
        print(f"golden_detectors {name}: {time.time() - t0:.1f} s", flush=True)
        return {"low_text": bp.low_text, "text_threshold": bp.text_threshold,
                "min_area": bp.min_area, "thresholds": rule,
                "pages": [{"page": i, "block_means": cs.block_means(h), "boxes": b,
                           "scores": sc} for i, h, (b, sc) in zip(ids, heats, found)]}

    dit_s1 = dit("dit_s1", PortViT.dit_synth_s1(), cs.DIT_PAGES)
    dit_default = dit("dit_default", DEFAULT_CONFIG, cs.DIT_DEFAULT_PAGES)

    t0 = time.time()
    seed = cs.DETECTOR_SEEDS["textfusenet"]
    bp = BoxProcessorTextFuseNet(config=TextFuseNetConfig.synth_s2(),
                                 variables=tree(PortTfn.synth_s2(), seed))
    apply = jax.jit(bp.model.apply)
    dense = [apply(bp.variables, normalize_page(padded(bp, rgb[i]))[None]) for i in cs.TFN_PAGES]
    found = detections(bp, cs.TFN_PAGES)
    rule = "defaults"
    if not any(len(b) for b, _ in found):
        rule = ("quantiles 0.90 / 0.95 of the pooled word maps (low_text, word_threshold), "
                "0.90 of the char maps, fuse_threshold 0")
        bp.low_text, bp.word_threshold = cs.detector_thresholds(
            [d["word"][0, ..., 0] for d in dense], (0.90, 0.95))
        bp.char_threshold, = cs.detector_thresholds([d["char"][0, ..., 0] for d in dense],
                                                    (0.90,))
        bp.fuse_threshold = 0.0
        found = detections(bp, cs.TFN_PAGES)
    if not any(len(b) for b, _ in found):
        rule += ", min_area 0"
        bp.min_area = 0
        found = detections(bp, cs.TFN_PAGES)
    rows = []
    for i, d, (b, sc) in zip(cs.TFN_PAGES, dense, found):
        st = jax.device_get(_tfn_detect_jit(bp.model, bp.variables, padded(bp, rgb[i]),
                                            bp.word_threshold, bp.low_text,
                                            bp.char_threshold))
        valid = np.nonzero(st["valid"])[0]
        rows.append({"page": i, "word_means": cs.block_means(d["word"][0]),
                     "char_means": cs.block_means(d["char"][0]),
                     "seg_means": cs.block_means(st["seg"]), "valid": valid,
                     "heat_boxes": st["heat_boxes"][valid],
                     "fused_scores": st["scores"][valid], "refined": st["boxes"][valid],
                     "boxes": b, "scores": sc})
    print(f"golden_detectors textfusenet: {time.time() - t0:.1f} s", flush=True)
    golden = {
        "settings": {
            "ink": "JAX PipelineOcrEngine(InkBoxProcessor(), trocr-fast3g2d6ov-synth greedy "
                   "bfloat16, batch sizes 32/128/256) on the 16 pages, SPARSE: [text, box, "
                   "confidence] per word",
            "dit": "BoxProcessorUlimDit at ViTConfig.dit_synth_s1() (dit_s1) and at the "
                   "no-tree configuration (dit_default), init_flax_layout(config, seed); "
                   "block_means: 16x16 means of the [h, w, 2] heatmap",
            "textfusenet": "BoxProcessorTextFuseNet at TextFuseNetConfig.synth_s2(), "
                           "init_flax_layout(config, seed); word/char/seg means: 16x16 means "
                           "of the dense maps (seg: the sigmoid); heat_boxes, fused_scores and "
                           "refined (stride-4 grid) on the valid slots",
            "seeds": cs.DETECTOR_SEEDS,
        },
        "ink": {"pages": ink},
        "dit_s1": dit_s1,
        "dit_default": dit_default,
        "textfusenet": {"low_text": bp.low_text, "word_threshold": bp.word_threshold,
                        "char_threshold": bp.char_threshold,
                        "fuse_threshold": bp.fuse_threshold, "min_area": bp.min_area,
                        "thresholds": rule,
                        "pages": rows},
    }
    _write_json("golden_detectors", golden, default=_json_default, separators=(",", ":"))


def _jax_order_and_scores(layout, boxes, scale):
    """JAX ``TextLayout.order`` with each box's score (its bands, B=1)."""
    import jax.numpy as jnp

    from marie_tpu.models.reading_order import _score_boxes

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
    if order != layout.order(boxes, scale=scale):
        raise AssertionError("the banded scores do not give TextLayout.order")
    return order, [float(f"{v:.9g}") for v in scores]


def export_reading_order() -> None:
    """golden_reading_order.json: the JAX reading order of the seeded
    base tree, and PIL's JPEG and G4 digests of the shipped pages."""
    import hashlib
    import io

    import jax
    import jax.numpy as jnp
    from PIL import Image

    import chip_smoke as cs
    from marie_tpu.models.reading_order import ReadingOrderConfig, TextLayout
    from marie_tpu_torch.document.layoutreader import page_word_boxes
    from marie_tpu_torch.models.reading_order import ReadingOrderConfig as PortConfig
    from marie_tpu_torch.registry.convert import init_flax_layout

    tree = init_flax_layout(PortConfig.base(), cs.READING_ORDER_SEED)
    layout = TextLayout(ReadingOrderConfig.base(), jax.tree_util.tree_map(jnp.asarray, tree))
    with open_zoo_json("golden") as f:
        pages = json.load(f)["pages"]
    rows = []
    for page in pages:
        order, scores = _jax_order_and_scores(layout, *page_word_boxes(page))
        rows.append({"order": order, "scores": scores})
    order, scores = _jax_order_and_scores(layout, cs.long_page_boxes(), 1024.0)

    def sha(b):
        return hashlib.sha256(b).hexdigest()

    with np.load(os.path.join(ZOO, "pages.npz")) as data:
        shipped = {"page0": data["pages"][0], "rgb": data["rgb"], "oversize": data["oversize"]}
    jpeg = {}
    for name in ("page0", "rgb"):
        img = shipped[name]
        buf = io.BytesIO()
        Image.fromarray(img if img.ndim == 3 else np.stack([img] * 3, -1)).save(
            buf, format="JPEG", quality=80)
        decoded = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))
        jpeg[name] = {"bytes": sha(buf.getvalue()), "decoded": sha(decoded.tobytes()),
                      "shape": list(decoded.shape)}
    g4 = {}
    for name in ("page0", "oversize"):
        buf = io.BytesIO()
        Image.fromarray(shipped[name] > 128).save(buf, format="TIFF", compression="group4")
        tiff = Image.open(io.BytesIO(buf.getvalue()))
        strips = [buf.getvalue()[o:o + n] for o, n in zip(tiff.tag_v2[273], tiff.tag_v2[279])]
        g4[name] = {"strips": sha(b"".join(strips)), "count": len(strips),
                    "rows_per_strip": tiff.tag_v2[278]}
    golden = {
        "settings": {
            "model": "marie_tpu TextLayout at ReadingOrderConfig.base() (hidden 128, 4 "
                     "layers, 4 heads, max_boxes 256), float32 on the CPU",
            "tree": "marie_tpu_torch init_flax_layout(ReadingOrderConfig.base(), seed)",
            "seed": cs.READING_ORDER_SEED,
            "pages": "golden.json pages: words' xywh boxes as xyxy, scale max(width, "
                     "height) (layoutreader.page_word_boxes)",
            "long_page": f"chip_smoke.long_page_boxes({cs.LONG_PAGE_WORDS}, "
                         f"{cs.LONG_PAGE_SEED}), scale 1024",
            "scores": "each box's score in its band, 9 significant digits",
            "jpeg": "PIL quality 80 of the RGB stack; sha256 of the file and of "
                    "convert('RGB') pixels",
            "g4": "PIL group4 TIFF of page > 128 (bool); sha256 of the strips joined",
        },
        "pages": rows,
        "long_page": {"order": order, "scores": scores},
        "jpeg": jpeg,
        "g4": g4,
    }
    _write_json("golden_reading_order", golden, separators=(",", ":"))


def export_train() -> None:
    """golden_train.json: the JAX-trained zoo trees on the held-out sets of
    the port's trainers at chip_smoke.py's train settings."""
    import jax
    import jax.numpy as jnp

    import chip_smoke as cs
    from marie_tpu.models.configs import LayoutLMConfig
    from marie_tpu.models.layoutlm import (
        LayoutLMv3ForSequenceClassification, LayoutLMv3ForTokenClassification)
    from marie_tpu.models.reading_order import ReadingOrderConfig, ReadingOrderModel
    from marie_tpu.registry.checkpoints import load_params as load_orbax
    from marie_tpu.train.reading_order import pairwise_rank_loss
    from marie_tpu_torch.components.word_tokenizer import (
        HashWordTokenizer, RollingWordTokenizer)
    from marie_tpu_torch.train import layout as tl
    from marie_tpu_torch.train import reading_order as tr

    def zoo(name):
        return jax.device_get(load_orbax(os.path.join(REPO, "model_zoo", name)))

    def logits(model, name, tokens, boxes, seq_len):
        return np.asarray(jax.jit(lambda p, a, b, c: model.apply(p, a, b, c, None))(
            zoo(name), jnp.asarray(tokens), jnp.asarray(boxes), jnp.asarray(seq_len)))

    seed, size = cs.TRAIN_SEED, cs.TRAIN_DATASET
    cfg = LayoutLMConfig.synth(2)
    rng = np.random.default_rng(seed)
    tok = HashWordTokenizer(cfg.vocab_size)
    tl.splitter_dataset(rng, size, tok, cfg)
    tt, tb, tls, ys, bundles = tl.splitter_heldout(rng, tok, cfg)
    split = tl.splitter_metrics(
        logits(LayoutLMv3ForSequenceClassification(cfg), "layout-splitter-synth",
               tt, tb, tls).argmax(-1), ys, bundles)

    labels = tuple(tl.CLASS_POOLS)
    ccfg = dataclasses.replace(LayoutLMConfig.synth(len(labels)),
                               max_seq_len=cs.CHAIN_SEQ_LEN)
    rtok = RollingWordTokenizer(ccfg.vocab_size)
    rng = np.random.default_rng(seed)
    tl.classifier_dataset(rng, size, labels, rtok, ccfg, True)
    held = tl.classifier_dataset(rng, 256, labels, rtok, ccfg, True)
    cls_acc = float((logits(LayoutLMv3ForSequenceClassification(ccfg),
                            "layout-classifier-chain", *held[:3]).argmax(-1)
                     == held[3]).mean())

    ncfg = dataclasses.replace(LayoutLMConfig.synth(5), max_seq_len=cs.CHAIN_SEQ_LEN)
    rng = np.random.default_rng(seed)
    tl.indexer_dataset(rng, size, rtok, ncfg, True)
    held = tl.indexer_dataset(rng, 128, rtok, ncfg, True)
    tok_acc = tl.token_accuracy(logits(LayoutLMv3ForTokenClassification(ncfg),
                                       "layout-indexer-chain", *held[:3]).argmax(-1), held)

    rcfg = ReadingOrderConfig.base()
    model = ReadingOrderModel(rcfg)
    boxes, ranks, n_valid = tr.make_batch(np.random.default_rng(seed + 1), cs.EVAL_PAGES,
                                          rcfg.max_boxes)
    scores = np.asarray(model.apply(zoo("reading-order-synth"), jnp.asarray(boxes),
                                    jnp.asarray(n_valid)))
    taus = [tr.kendall_tau(np.argsort(scores[b, :n], kind="stable"),
                           np.argsort(ranks[b, :n], kind="stable"))
            for b, n in enumerate(n_valid)]
    _, pair_acc = pairwise_rank_loss(jnp.asarray(scores), jnp.asarray(ranks),
                                     jnp.asarray(n_valid))
    golden = {
        "settings": {
            "seed": seed, "dataset_size": size, "chain_max_seq_len": cs.CHAIN_SEQ_LEN,
            "eval_pages": cs.EVAL_PAGES,
            "trees": "model_zoo/ (orbax, trained by the JAX scripts/train_*.py)",
            "heldout": "the port's train/layout.py and train/reading_order.py "
                       "generators at the seed: the training set drawn, then the held-out "
                       "set (reading order: evaluate_reading_order's pages, seed + 1)",
        },
        "splitter": {"tree": "layout-splitter-synth", **split},
        "classifier_chain": {"tree": "layout-classifier-chain", "accuracy": cls_acc},
        "indexer_chain": {"tree": "layout-indexer-chain", "token_accuracy": tok_acc},
        "reading_order": {"tree": "reading-order-synth", "kendall_tau": float(np.mean(taus)),
                          "pair_accuracy": float(pair_acc)},
        "ocr": _ocr_train_golden(cs),
        "boundary": _boundary_train_golden(cs),
    }
    _write_json("golden_train", golden, indent=1)
    print(json.dumps(golden), flush=True)


def _ocr_train_golden(cs) -> dict:
    """The OCR trees of ``torch_zoo/`` (the serving ``.npz``, as the port
    reads them) on the JAX package's held-out renders, drawn by PIL: the
    recognizer's and the CRNN's CER (``evaluate_cer`` / ``evaluate_crnn_cer``
    on clean crops of seed ``OCR_HELDOUT_SEED``) and CRAFT's weighted MSE
    on ``render_page_with_targets`` pages of that seed."""
    import jax
    import jax.numpy as jnp

    from marie_tpu.models.configs import CraftConfig, CRNNConfig, TrOCRConfig
    from marie_tpu.models.craft import CRAFT
    from marie_tpu.models.crnn import CRNN
    from marie_tpu.models.tokenizer import CharTokenizer, CTCCharTokenizer
    from marie_tpu.models.trocr import TrOCRModel
    from marie_tpu.train.craft import render_page_with_targets
    from marie_tpu.train.crnn import _crnn_render_config, evaluate_crnn_cer
    from marie_tpu.train.recognizer import SyntheticWordDataset, evaluate_cer
    from marie_tpu_torch.registry.checkpoints import load_params

    def tree(name):
        return load_params(os.path.join(ZOO, f"{name}.npz"))

    seed = cs.OCR_HELDOUT_SEED
    recipe = cs.RECOGNIZER_RECIPE
    cfg = TrOCRConfig.fast_v3_g2_d6()
    tok = CharTokenizer()
    ds = SyntheticWordDataset(cfg, tok, seed=seed, noise=0.0, rotate_deg=recipe["rotate_deg"],
                              lowres_p=0.0, text_mode=recipe["text_mode"],
                              font_sizes=recipe["font_sizes"])
    trocr_cer = evaluate_cer(TrOCRModel(cfg), tree(cs.OCR_TREES["recognizer"]), ds, tok,
                             n_samples=cs.OCR_EVAL_CROPS)
    crnn_ds = SyntheticWordDataset(_crnn_render_config(cs.CRNN_WIDTH, 32), seed=seed,
                                   noise=0.0, lowres_p=0.0)
    crnn_cer = evaluate_crnn_cer(CRNN(CRNNConfig()), tree(cs.OCR_TREES["crnn"]), crnn_ds,
                                 CTCCharTokenizer(), n_samples=cs.OCR_EVAL_CROPS)
    ccfg = CraftConfig.fast_s2d2()
    rng = np.random.default_rng(seed)
    pages, targets = zip(*(render_page_with_targets(rng, cs.CRAFT_PAGE_HW,
                                                    out_stride=ccfg.out_stride)
                           for _ in range(cs.CRAFT_EVAL_PAGES)))
    apply = jax.jit(lambda v, x: CRAFT(ccfg).apply(v, x))
    variables = tree(cs.OCR_TREES["craft"])
    losses = []
    for s in range(0, cs.CRAFT_EVAL_PAGES, 8):
        x = jnp.asarray(np.stack(pages[s:s + 8]), jnp.float32) / 255.0
        t = jnp.asarray(np.stack(targets[s:s + 8]), jnp.float32) / 255.0
        out = apply(variables, x)
        losses += list(np.asarray(((1.0 + 9.0 * t) * (out - t) ** 2).mean(axis=(1, 2, 3))))
    return {
        "settings": {"heldout_seed": seed, "crops": cs.OCR_EVAL_CROPS,
                     "craft_pages": cs.CRAFT_EVAL_PAGES, "craft_page_hw": list(cs.CRAFT_PAGE_HW),
                     "recognizer_recipe": {k: list(v) if isinstance(v, tuple) else v
                                           for k, v in recipe.items()},
                     "crnn_width": cs.CRNN_WIDTH,
                     "renders": "the JAX package's SyntheticWordDataset and "
                                "render_page_with_targets (PIL, DejaVu), clean: no noise, "
                                "no low-resolution pass; the recognizer's held-out set as "
                                "train_recognizer_device draws it (no bold or shear)",
                     "trees": "torch_zoo/*.npz, float32 forwards"},
        "recognizer": {"tree": cs.OCR_TREES["recognizer"], "cer": trocr_cer},
        "crnn": {"tree": cs.OCR_TREES["crnn"], "cer": crnn_cer},
        "craft": {"tree": cs.OCR_TREES["craft"], "weighted_mse": float(np.mean(losses))},
    }


def _boundary_train_golden(cs) -> dict:
    """``model_zoo/boundary-synth`` (``BoundaryConfig()``) on the JAX
    trainer's own held-out scans: ``evaluate_boundary``'s figures over
    BOUNDARY_EVAL_PAGES pages of seed BOUNDARY_EVAL_SEED (its quads and
    noise from ``jax.random``: the port draws other ones, so the figures
    compare distributions, not pages)."""
    import jax

    from marie_tpu.models.boundary import BoundaryNet
    from marie_tpu.models.configs import BoundaryConfig
    from marie_tpu.registry.checkpoints import load_params as load_orbax
    from marie_tpu.train.boundary import evaluate_boundary

    cfg = BoundaryConfig()
    params = jax.device_get(load_orbax(os.path.join(REPO, "model_zoo", "boundary-synth")))
    metrics = evaluate_boundary(BoundaryNet(cfg), params, cfg, n_pages=cs.BOUNDARY_EVAL_PAGES,
                                seed=cs.BOUNDARY_EVAL_SEED)
    return {"tree": "boundary-synth", "pages": cs.BOUNDARY_EVAL_PAGES,
            "seed": cs.BOUNDARY_EVAL_SEED, **metrics}


def _cut(page, box):
    x, y, w, h = box
    return np.ascontiguousarray(page[y:y + h, x:x + w])


def _write_json(name: str, obj, **dump_kwargs) -> None:
    """``torch_zoo/<name>.json.gz``: ``json.dumps(obj, **dump_kwargs)``
    gzipped at level 9, with no file name and no time stamp, so that the
    same content gives the same bytes."""
    import gzip

    text = json.dumps(obj, **dump_kwargs).encode("utf-8")
    with open(zoo_json_path(name), "wb") as raw:
        with gzip.GzipFile(filename="", mode="wb", compresslevel=9, fileobj=raw, mtime=0) as f:
            f.write(text)


def _json_default(x):
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, np.ndarray):
        return x.tolist()
    raise TypeError(type(x))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--all", action="store_true",
                    help="also write the -synth classifier, indexer and splitter")
    ap.add_argument("--best", action="store_true",
                    help="write only crnn-synth.npz and golden_best.json")
    ap.add_argument("--classify", action="store_true",
                    help="write only golden_classify.json")
    ap.add_argument("--extract", action="store_true",
                    help="write only golden_extract.json")
    ap.add_argument("--register", action="store_true",
                    help="write only golden_register.json")
    ap.add_argument("--detectors", action="store_true",
                    help="write only golden_detectors.json")
    ap.add_argument("--reading-order", action="store_true",
                    help="write only golden_reading_order.json")
    ap.add_argument("--train", action="store_true", help="write only golden_train.json")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    if args.best:
        export_best()
        return
    if args.classify:
        export_classify()
        return
    if args.extract:
        export_extract()
        return
    if args.register:
        export_register()
        return
    if args.detectors:
        export_detectors()
        return
    if args.reading_order:
        export_reading_order()
        return
    if args.train:
        export_train()
        return
    from bench import make_pages
    from marie_tpu.enums import PSMode

    os.makedirs(ZOO, exist_ok=True)
    export_trees(SERVING_TREES + (OTHER_TREES if args.all else ()))

    pages, truths = make_pages(N_PAGES, seed=PAGE_SEED, with_truth=True)
    (rgb, rgb_truth), (oversize, big_truth) = make_forms(pages, truths)
    stack = np.stack(pages)
    with open(os.path.join(ZOO, "pages.npz"), "wb") as f:
        np.savez_compressed(f, pages=stack, rgb=rgb, oversize=oversize)
    truth = {"pages": truths, "rgb": rgb_truth, "oversize": big_truth}
    requests = make_requests(truths)

    engine = serving_engine()
    t0 = time.time()
    golden = {
        "settings": {
            "detector": "craft-s2d2-synth heatmap, text_threshold 0.6, low_text 0.4, "
                        "max_components 256, cc_runs 32, bfloat16",
            "recognizer": "trocr-fast3g2d6ov-synth greedy, bfloat16, batch sizes 32/128/256",
            "heads": "layout-classifier-chain, layout-indexer-chain (float32, cap 192)",
            "engine": "upload u2, compact_slots 160, page_fuse_batch 16, default buckets",
            "pages": f"bench.py make_pages({N_PAGES}, seed={PAGE_SEED})",
        },
        "pages": engine.extract(list(stack)),
        "forms": {"rgb": engine.extract([rgb])[0], "oversize": engine.extract([oversize])[0]},
        "regions": {"request": requests["regions"],
                    "result": engine.extract(list(stack), regions=requests["regions"])},
        "modes": {
            mode: dict(spec, result=engine.extract(
                [_cut(stack[spec["page"]], spec["box"])], PSMode.from_value(mode))[0])
            for mode, spec in requests["modes"].items()
        },
    }
    print(f"golden: {time.time() - t0:.1f} s", flush=True)
    for name, obj in (("truth", truth), ("golden", golden)):
        _write_json(name, obj, default=_json_default, separators=(",", ":"))
    export_best()
    export_classify()
    export_extract()
    export_register()
    export_detectors()
    export_reading_order()
    sizes = {n: os.path.getsize(os.path.join(ZOO, n)) for n in sorted(os.listdir(ZOO))}
    print(json.dumps({"bytes": sizes, "total": sum(sizes.values())}))


if __name__ == "__main__":
    main()
