"""Trainers of the port (counterpart of ``marie_tpu/train/``): the LayoutLM
heads (:mod:`.layout`: splitter, classifier, indexer; the chained heads are
the classifier and indexer with ``RollingWordTokenizer`` and shuffled
words) and the reading-order ranker (:mod:`.reading_order`), trained on
the card.

The JAX package's other trainers (recognizer, CRNN, CRAFT, boundary, DiT,
overlay, TextFuseNet) render their data with PIL fonts, which the card's
machine does not have; they wait for ROADMAP §1 item 8.2, and the names
the JAX package exports from here for them raise naming it.
"""

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

_PIL_TRAINERS = "the PIL-rendered trainers (ROADMAP §1 item 8.2)"


def train_recognizer(*args, **kwargs):
    raise NotImplementedError(f"train_recognizer is not ported: it waits for {_PIL_TRAINERS}")


class SyntheticWordDataset:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f"SyntheticWordDataset is not ported: it waits for {_PIL_TRAINERS}")


__all__ = ["SyntheticWordDataset", "evaluate_reading_order", "train_layout_classifier",
           "train_layout_indexer", "train_layout_splitter", "train_reading_order",
           "train_reading_order_device", "train_recognizer"]
