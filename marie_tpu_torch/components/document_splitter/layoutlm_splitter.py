"""Document splitter (port of
``marie_tpu/components/document_splitter/layoutlm_splitter.py``): per-page
boundary classification with the sequence classifier; pages labelled as
boundaries start new documents.

The JAX splitter's default weights come from ``model_zoo/
layout-splitter-synth``, an orbax checkpoint the port does not read; here
the caller passes ``config`` (and ``params``) until ROADMAP §1 item 2
brings an ``.npz`` counterpart.
"""

from typing import Any, Dict, List, Optional, Sequence

from marie_tpu_torch.components.base import ZOO_REFUSAL, BaseDocumentSplitter, PageInput
from marie_tpu_torch.components.document_classifier.layoutlm_classifier import (
    LayoutDocumentClassifier,
)
from marie_tpu_torch.models.configs import LayoutLMConfig


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
        if params is None and config is None:
            raise NotImplementedError(f"layout-splitter-synth: {ZOO_REFUSAL}; "
                                      "pass config (and params)")
        self.boundary_label = boundary_label
        self.classifier = LayoutDocumentClassifier(labels=labels, config=config,
                                                   params=params, device=device)

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
