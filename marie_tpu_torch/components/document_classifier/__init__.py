from marie_tpu_torch.components.document_classifier.layoutlm_classifier import (
    LayoutDocumentClassifier,
)

__all__ = ["LayoutDocumentClassifier"]
