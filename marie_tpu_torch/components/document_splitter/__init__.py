from marie_tpu_torch.components.document_splitter.layoutlm_splitter import (
    LayoutDocumentSplitter,
)

__all__ = ["LayoutDocumentSplitter"]
