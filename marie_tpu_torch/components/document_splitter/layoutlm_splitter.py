"""Document splitter (port of
``marie_tpu/components/document_splitter/layoutlm_splitter.py``): per-page
boundary classification with the sequence classifier; pages labelled as
boundaries start new documents.  Without ``config`` and ``params`` the
weights are the zoo's ``layout-splitter-synth`` when ``torch_zoo/`` holds
it, else the classifier's seeded base-width ones, as in the JAX package.
"""

from typing import Any, Dict, List, Optional, Sequence

from marie_tpu_torch.components.base import BaseDocumentSplitter, PageInput
from marie_tpu_torch.components.document_classifier.layoutlm_classifier import (
    LayoutDocumentClassifier,
)
from marie_tpu_torch.models.configs import LayoutLMConfig
from marie_tpu_torch.registry.zoo import zoo_params


class LayoutDocumentSplitter(BaseDocumentSplitter):
    def __init__(
        self,
        labels: Sequence[str] = ("continuation", "boundary"),
        boundary_label: str = "boundary",
        config: Optional[LayoutLMConfig] = None,
        params=None,
        *,
        device="cuda",
    ):
        zoo_name = None
        if params is None and config is None:
            params = zoo_params("layout-splitter-synth")
            if params is not None:
                zoo_name, config = ("layout-splitter-synth",
                                    LayoutLMConfig.synth(num_labels=len(labels)))
        self.boundary_label = boundary_label
        self.classifier = LayoutDocumentClassifier(labels=labels, config=config,
                                                   params=params, device=device)
        self.classifier.zoo_name = zoo_name

    def split(self, pages: Sequence[PageInput]) -> List[Dict[str, Any]]:
        out = []
        for i, p in enumerate(self.classifier.predict(pages)):
            out.append({
                "label": p["label"],
                "score": p["score"],
                # first page always starts a document
                "is_boundary": i == 0 or p["label"] == self.boundary_label,
            })
        return out

    @staticmethod
    def to_documents(split_results: List[Dict[str, Any]]) -> List[List[int]]:
        """Group page indices into documents by boundary flags."""
        docs: List[List[int]] = []
        for i, r in enumerate(split_results):
            if r["is_boundary"] or not docs:
                docs.append([i])
            else:
                docs[-1].append(i)
        return docs
