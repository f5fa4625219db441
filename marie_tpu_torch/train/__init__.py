"""Trainers of the port (counterpart of ``marie_tpu/train/``): the LayoutLM
heads (:mod:`.layout`: splitter, classifier, indexer; the chained heads are
the classifier and indexer with ``RollingWordTokenizer`` and shuffled
words), the reading-order ranker (:mod:`.reading_order`), and the trainers
on synthetic renders drawn with the glyph atlas (``utils/glyphs.py``): the
TrOCR recognizer (:mod:`.recognizer`), the CRNN (:mod:`.crnn`), the CRAFT
detector (:mod:`.craft`), the boundary regressor (:mod:`.boundary`), the
DiT detector (:mod:`.dit`), TextFuseNet (:mod:`.textfusenet`) and the
overlay cleanup GAN (:mod:`.overlay`), trained on the card.
"""

from marie_tpu_torch.train.boundary import evaluate_boundary, train_boundary_device
from marie_tpu_torch.train.craft import render_page_with_targets, train_craft_device
from marie_tpu_torch.train.crnn import evaluate_crnn_cer, train_crnn_device
from marie_tpu_torch.train.dit import train_dit_device
from marie_tpu_torch.train.layout import (
    train_layout_classifier,
    train_layout_indexer,
    train_layout_splitter,
)
from marie_tpu_torch.train.overlay import evaluate_overlay, render_overlay_pair, train_overlay_device
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
from marie_tpu_torch.train.textfusenet import render_page_tfn, train_textfusenet_device

__all__ = ["SyntheticWordDataset", "character_error_rate", "evaluate_boundary", "evaluate_cer",
           "evaluate_crnn_cer", "evaluate_overlay", "evaluate_reading_order",
           "render_overlay_pair", "render_page_tfn",
           "render_page_with_targets", "train_boundary_device",
           "train_craft_device", "train_crnn_device", "train_dit_device",
           "train_layout_classifier", "train_layout_indexer", "train_layout_splitter",
           "train_overlay_device", "train_reading_order", "train_reading_order_device",
           "train_recognizer", "train_recognizer_device", "train_textfusenet_device"]
