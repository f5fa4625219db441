"""Component base classes (copy of ``marie_tpu/components/base.py``
without its config-file and logger mixins): the page input of the layout
heads and the classifier, splitter and indexer interfaces."""

from abc import ABC, abstractmethod
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

class PageInput:
    """One page's inputs for layout models: OCR words + boxes (+ image).

    Boxes are xywh in page pixels; they are normalised to the model's
    coordinate buckets internally."""

    def __init__(self, words: Sequence[str], boxes: Sequence[Sequence[float]],
                 image: Optional[np.ndarray] = None, page_size: Optional[tuple] = None):
        self.words = list(words)
        self.boxes = [list(b) for b in boxes]
        self.image = image
        if page_size is None and image is not None:
            page_size = (image.shape[1], image.shape[0])  # (w, h)
        if page_size is None and self.boxes:
            # content extent: keeps coordinate normalization consistent
            # whatever physical page the boxes came from
            page_size = (max(b[0] + b[2] for b in self.boxes),
                         max(b[1] + b[3] for b in self.boxes))
        self.page_size = page_size or (1000, 1000)

    @staticmethod
    def from_ocr_result(result: Dict[str, Any], image: Optional[np.ndarray] = None):
        words = [w["text"] for w in result.get("words", [])]
        boxes = [w["box"] for w in result.get("words", [])]
        size = (result["meta"]["imageSize"]["width"], result["meta"]["imageSize"]["height"])
        return PageInput(words, boxes, image, size)


class BaseDocumentClassifier(ABC):
    @abstractmethod
    def predict(self, pages: Sequence[PageInput]) -> List[Dict[str, Any]]:
        """-> per page {"label": str, "score": float, "scores": {label: p}}."""

    def run(self, pages: Sequence[PageInput]) -> List[Dict[str, Any]]:
        return self.predict(pages)


class BaseDocumentSplitter(ABC):
    @abstractmethod
    def split(self, pages: Sequence[PageInput]) -> List[Dict[str, Any]]:
        """-> per page {"label": str, "score": float, "is_boundary": bool}."""


class BaseDocumentIndexer(ABC):
    @abstractmethod
    def index(self, pages: Sequence[PageInput]) -> List[Dict[str, Any]]:
        """-> per page {"entities": [{"label", "text", "score", "word_span"}]}."""
