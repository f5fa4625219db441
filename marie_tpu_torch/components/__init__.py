"""Document-AI components (classification, splitting, indexing/NER,
registration, template matching), counterparts of
``marie_tpu/components/``."""

from marie_tpu_torch.components.base import (
    BaseDocumentClassifier,
    BaseDocumentIndexer,
    BaseDocumentSplitter,
)

__all__ = [
    "BaseDocumentClassifier",
    "BaseDocumentIndexer",
    "BaseDocumentSplitter",
]
