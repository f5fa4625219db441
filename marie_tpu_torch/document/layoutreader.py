"""Reading order of OCR results (port of
``marie_tpu/document/layoutreader.py``): a :class:`TextLayout` with the
trained reading-order tree when the port's zoo holds one, and
:func:`reorder_page_result`, which puts a page result's words into that
order.

The trained tree is read from ``torch_zoo/reading-order-synth.npz``
(:mod:`marie_tpu_torch.registry.checkpoints`) when that file is there.
Without it the weights are drawn from ``init_flax_layout(config, seed=0)``;
the JAX loader falls back to flax's ``PRNGKey(0)`` init, which the port
cannot repeat, so the two fallbacks are different untrained models (hand
both the same tree to compare them).
"""

from typing import Optional

from marie_tpu_torch.models.reading_order import ReadingOrderConfig, TextLayout
from marie_tpu_torch.registry.zoo import zoo_checkpoint

ZOO_NAME = "reading-order-synth"


def load_text_layout(
    checkpoint: Optional[str] = None,
    config: Optional[ReadingOrderConfig] = None,
    device=None,
) -> TextLayout:
    """A :class:`TextLayout` from ``checkpoint`` (a ``.npz`` tree), else
    from the zoo's trained tree, else seeded (``trained`` is None then);
    on ``device`` (None: the card)."""
    from marie_tpu_torch.registry.checkpoints import load_params

    cfg = config or ReadingOrderConfig.base()
    path = checkpoint or zoo_checkpoint(ZOO_NAME)
    params = load_params(path) if path else None
    layout = TextLayout(cfg, params, seed=0, device="cuda" if device is None else device)
    layout.trained = path
    return layout


def page_word_boxes(result: dict):
    """(xyxy boxes, scale) of a page result's words, as
    :func:`reorder_page_result` orders them: the xywh pixel boxes as xyxy,
    the scale the page's longer side."""
    size = result["meta"]["imageSize"]
    boxes = [[wd["box"][0], wd["box"][1], wd["box"][0] + wd["box"][2],
              wd["box"][1] + wd["box"][3]] for wd in result.get("words", [])]
    return boxes, float(max(size["width"], size["height"]))


def reorder_page_result(result: dict, text_layout: TextLayout) -> dict:
    """A page result (``{"meta", "words", "lines"}``, as
    :func:`marie_tpu_torch.document.ocr_processor.assemble_page_result`
    makes it) with its words in the model's reading order: word ids are
    given anew in that order, and each line's ``wordids`` and text follow.
    The boxes are xywh in pixels; they are ordered as xyxy scaled by the
    page's longer side (:func:`page_word_boxes`)."""
    words = result.get("words", [])
    if len(words) < 2:
        return result
    order = text_layout.order(*page_word_boxes(result))
    new_words = []
    id_map = {}
    for new_id, old_idx in enumerate(order):
        wd = dict(words[old_idx])
        id_map[wd["id"]] = new_id
        wd["id"] = new_id
        new_words.append(wd)
    out = dict(result)
    out["words"] = new_words
    by_id = {wd["id"]: wd["text"] for wd in new_words}
    new_lines = []
    for line in result.get("lines", []):
        ln = dict(line)
        ids = sorted(id_map[i] for i in line.get("wordids", []) if i in id_map)
        ln["wordids"] = ids
        ln["text"] = " ".join(by_id[i] for i in ids)
        new_lines.append(ln)
    out["lines"] = new_lines
    return out


__all__ = ["TextLayout", "ReadingOrderConfig", "load_text_layout", "page_word_boxes",
           "reorder_page_result"]
