"""BasePipeline — shared classifier and indexer chaining (port of
``marie_tpu/pipe/base_pipeline.py`` as a plain class: the JAX package's
YAML-configurable base, ``JAMLCompatible``, is on no ported path).

After OCR, page inputs go to every configured classifier (with a
majority vote per page) and indexer; the results are attached to the
document's metadata.
"""

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from marie_tpu_torch.components.base import PageInput
from marie_tpu_torch.logging_core import MarieLogger
from marie_tpu_torch.pipe.voting import majority_vote


class BasePipeline:
    def __init__(
        self,
        classifiers: Optional[Sequence] = None,
        indexers: Optional[Sequence] = None,
        **kwargs,
    ):
        self.logger = MarieLogger(type(self).__name__)
        self.classifiers = list(classifiers or [])
        self.indexers = list(indexers or [])

    def execute_classifier_and_indexer_pipeline(
        self,
        frames: List[np.ndarray],
        ocr_results: List[Dict[str, Any]],
        metadata: Dict[str, Any],
        classifier_enabled: bool = True,
        indexer_enabled: bool = True,
    ) -> Dict[str, Any]:
        pages = [
            PageInput.from_ocr_result(res, frame)
            for res, frame in zip(ocr_results, frames)
        ]

        if classifier_enabled and self.classifiers:
            per_classifier = [clf.predict(pages) for clf in self.classifiers]
            page_classifications = []
            for page_idx in range(len(pages)):
                candidates = [pc[page_idx] for pc in per_classifier]
                page_classifications.append(majority_vote(candidates))
            metadata["page_classifier"] = [
                {
                    "page": i,
                    "classification": c["label"],
                    "score": c["score"],
                }
                for i, c in enumerate(page_classifications)
            ]

        if indexer_enabled and self.indexers:
            indexer_results = []
            for indexer in self.indexers:
                per_page = indexer.index(pages)
                indexer_results.append(
                    [
                        {"page": i, "entities": r["entities"]}
                        for i, r in enumerate(per_page)
                    ]
                )
            metadata["page_indexer"] = (
                indexer_results[0] if len(indexer_results) == 1 else indexer_results
            )
        return metadata
