"""DocumentClassificationExecutor (port of
``marie_tpu/executor/classifier_executor.py``): ``/document/classify``
over the port's ``LayoutDocumentClassifier`` (the zoo's synthetic-trained
classifier, else a seeded base-width one, on ``device``)."""

from typing import Any, Dict

import numpy as np

from marie_tpu_torch.components.base import PageInput
from marie_tpu_torch.serve.executors import BaseExecutor
from marie_tpu_torch.serve.executors.decorators import requests, safely_encoded
from marie_tpu_torch.types.docs import DocumentArray


class DocumentClassificationExecutor(BaseExecutor):
    def __init__(self, classifier=None, labels=None, device="cuda", **kwargs):
        super().__init__(**kwargs)
        if classifier is None:
            from marie_tpu_torch.components.document_classifier import (
                LayoutDocumentClassifier,
            )

            classifier = LayoutDocumentClassifier.from_zoo(device=device)
            if classifier is None:
                from marie_tpu_torch.models.configs import LayoutLMConfig

                labels = tuple(labels or ("negative", "positive"))
                classifier = LayoutDocumentClassifier(
                    labels=labels, config=LayoutLMConfig.base(num_labels=len(labels)),
                    device=device)
        self.classifier = classifier

    @requests(on="/document/classify")
    @safely_encoded
    def classify(self, docs: DocumentArray, parameters: Dict[str, Any], **kwargs):
        pages = []
        for doc in docs:
            image = np.asarray(doc.tensor).astype(np.uint8) if doc.tensor is not None else None
            pages.append(PageInput(doc.tags.get("words", []), doc.tags.get("boxes", []), image))
        preds = self.classifier.predict(pages)
        for doc, pred in zip(docs, preds):
            doc.tags["classification"] = pred
        return {"status": "succeeded", "classifications": preds}
