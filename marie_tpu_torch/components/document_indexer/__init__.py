from marie_tpu_torch.components.document_indexer.layoutlm_indexer import (
    LayoutDocumentIndexer,
)

__all__ = ["LayoutDocumentIndexer"]
