"""Trainers of the port (counterpart of ``marie_tpu/train/``): the LayoutLM
heads (:mod:`.layout`: splitter, classifier, indexer; the chained heads are
the classifier and indexer with ``RollingWordTokenizer`` and shuffled
words), the reading-order ranker (:mod:`.reading_order`), and the OCR
trainers on synthetic renders drawn with the glyph atlas
(``utils/glyphs.py``): the TrOCR recognizer (:mod:`.recognizer`), the
CRNN (:mod:`.crnn`) and the CRAFT detector (:mod:`.craft`), trained on
the card.

The JAX package's other renderer-fed trainers (DiT, boundary, overlay,
TextFuseNet) are not ported yet: ROADMAP §1 item 8.2 names them, and their
names here raise naming it.
"""

from marie_tpu_torch.train.craft import render_page_with_targets, train_craft_device
from marie_tpu_torch.train.crnn import evaluate_crnn_cer, train_crnn_device
from marie_tpu_torch.train.layout import (
    train_layout_classifier,
    train_layout_indexer,
    train_layout_splitter,
)
from marie_tpu_torch.train.reading_order import (
    evaluate_reading_order,
    train_reading_order,
    train_reading_order_device,
)
from marie_tpu_torch.train.recognizer import (
    SyntheticWordDataset,
    character_error_rate,
    evaluate_cer,
    train_recognizer,
    train_recognizer_device,
)

_NEXT_TRAINERS = "the rest of the renderer-fed trainers (ROADMAP §1 item 8.2)"


def _not_ported(name: str):
    def stub(*args, **kwargs):
        raise NotImplementedError(f"{name} is not ported: it waits for {_NEXT_TRAINERS}")

    stub.__name__ = name
    return stub


train_dit_device = _not_ported("train_dit_device")
train_boundary_device = _not_ported("train_boundary_device")
train_overlay_device = _not_ported("train_overlay_device")
train_textfusenet_device = _not_ported("train_textfusenet_device")

__all__ = ["SyntheticWordDataset", "character_error_rate", "evaluate_cer", "evaluate_crnn_cer",
           "evaluate_reading_order", "render_page_with_targets", "train_boundary_device",
           "train_craft_device", "train_crnn_device", "train_dit_device",
           "train_layout_classifier", "train_layout_indexer", "train_layout_splitter",
           "train_overlay_device", "train_reading_order", "train_reading_order_device",
           "train_recognizer", "train_recognizer_device", "train_textfusenet_device"]
