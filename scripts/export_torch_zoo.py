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
    with open(os.path.join(ZOO, "truth.json")) as f:
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
    with open(os.path.join(ZOO, "golden_best.json"), "w") as f:
        json.dump(golden, f, default=_json_default, separators=(",", ":"))


def _cut(page, box):
    x, y, w, h = box
    return np.ascontiguousarray(page[y:y + h, x:x + w])


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
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    if args.best:
        export_best()
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
    for name, obj in (("truth.json", truth), ("golden.json", golden)):
        with open(os.path.join(ZOO, name), "w") as f:
            json.dump(obj, f, default=_json_default, separators=(",", ":"))
    export_best()
    sizes = {n: os.path.getsize(os.path.join(ZOO, n)) for n in sorted(os.listdir(ZOO))}
    print(json.dumps({"bytes": sizes, "total": sum(sizes.values())}))


if __name__ == "__main__":
    main()
