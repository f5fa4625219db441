"""API doc schemas (port of the doc classes of ``marie_tpu/api/``)."""

from marie_tpu_torch.api.docs import (
    DOC_KEY_ASSET_KEY,
    DOC_KEY_CLASSIFICATION,
    DOC_KEY_INDEXER,
    DOC_KEY_PAGE_NUMBER,
    AssetKeyDoc,
    BatchableMarieDoc,
    MarieDoc,
    OutputDoc,
    StorageDoc,
)

__all__ = ["AssetKeyDoc", "BatchableMarieDoc", "DOC_KEY_ASSET_KEY", "DOC_KEY_CLASSIFICATION",
           "DOC_KEY_INDEXER", "DOC_KEY_PAGE_NUMBER", "MarieDoc", "OutputDoc", "StorageDoc"]
