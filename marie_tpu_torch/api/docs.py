"""API doc schemas (port of ``marie_tpu/api/docs.py``) on
:class:`marie_tpu_torch.types.docs.BaseDoc`: the same fields, defaults
and JSON."""

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np

from marie_tpu_torch.types.docs import BaseDoc, Document, _to_numpy

DOC_KEY_PAGE_NUMBER = "page_number"
DOC_KEY_CLASSIFICATION = "classification"
DOC_KEY_INDEXER = "indexer"
DOC_KEY_ASSET_KEY = "asset_key"


class AssetKeyDoc(BaseDoc):
    """Points at a stored document asset plus an optional page subset."""

    asset_key: str
    pages: Optional[List[int]] = None


class StorageDoc(BaseDoc):
    content: Optional[Any] = None
    blob: Optional[Any] = None
    tensor: Optional[np.ndarray] = None
    tags: Optional[Dict[str, Any]] = None
    embedding: Optional[np.ndarray] = None

    def _coerce(self) -> None:
        self.tensor = _to_numpy(self.tensor)
        self.embedding = _to_numpy(self.embedding)


class MarieDoc(Document):
    """Image doc with tags."""

    tags: Dict[str, Any] = dataclasses.field(default_factory=dict)


class BatchableMarieDoc(MarieDoc):
    words: List[Any] = dataclasses.field(default_factory=list)
    boxes: List[Any] = dataclasses.field(default_factory=list)


class OutputDoc(BaseDoc):
    jobid: str
    status: str
