"""NerExtractionExecutor (port of ``marie_tpu/executor/ner_executor.py``):
``/ner/extract``, words and boxes -> reading order -> token
classification -> entities.

Each document brings its words and xywh boxes in ``tags`` (or, with an
``ocr_engine``, a page tensor to read them from).  With a reading-order
model the words are put in its order first: the boxes go to it as xyxy
with the page's longer side as the scale (the span of the boxes when the
document has no tensor).  The indexer (``LayoutDocumentIndexer``) gives
the entities, which land in ``tags["indexer"]`` and the answer
``{"status": "succeeded", "entities"}``.

``reading_order``: True loads :func:`load_text_layout` (the zoo's trained
tree, else a seeded one), None loads it when the zoo holds the trained
tree, False never.  A load that fails is logged and the executor serves
unordered (``text_layout`` None), as the JAX executor does.  The indexer
defaults to the zoo's synthetic-trained one, else a seeded base-width
one.  Every model runs on ``device`` (the card by default).
``ocr_engine`` is an engine, or (port-only, for YAML) the name of a
registry engine (``get_known_ocr_engines``).
"""

from typing import Any, Dict, Optional

import numpy as np

from marie_tpu_torch.components.base import PageInput
from marie_tpu_torch.executor.storage import StorageMixin
from marie_tpu_torch.serve.executors import BaseExecutor
from marie_tpu_torch.serve.executors.decorators import requests, safely_encoded
from marie_tpu_torch.types.docs import DocumentArray


def reading_order_boxes(boxes, image: Optional[np.ndarray]):
    """xywh boxes -> (xyxy boxes, scale) as the executor hands them to the
    reading-order model."""
    xyxy = [[b[0], b[1], b[0] + b[2], b[1] + b[3]] for b in boxes]
    if image is not None:
        span = float(max(image.shape[0], image.shape[1]))
    else:
        span = max((max(b[2], b[3]) for b in xyxy), default=1.0)
    return xyxy, max(span, 1.0)


class NerExtractionExecutor(StorageMixin, BaseExecutor):
    def __init__(self, indexer=None, ocr_engine=None, labels=None,
                 reading_order: Optional[bool] = None,
                 storage_enabled: bool = False,
                 storage_conf: Optional[Dict[str, Any]] = None, device="cuda", **kwargs):
        super().__init__(**kwargs)
        self.setup_storage(storage_enabled, storage_conf, silence_exceptions=True)
        self.text_layout = None
        if reading_order is not False:
            try:
                from marie_tpu_torch.document.layoutreader import ZOO_NAME, load_text_layout
                from marie_tpu_torch.registry.zoo import zoo_checkpoint

                if reading_order or zoo_checkpoint(ZOO_NAME) is not None:
                    self.text_layout = load_text_layout(device=device)
            except Exception as ex:  # noqa: BLE001 — ordering is best-effort, as in JAX
                self.logger.warning(f"reading order not loaded, serving unordered: {ex!r}")
                self.text_layout = None
        if indexer is None:
            from marie_tpu_torch.components.document_indexer import LayoutDocumentIndexer

            indexer = LayoutDocumentIndexer.from_zoo(device=device)
            if indexer is None:
                from marie_tpu_torch.models.configs import LayoutLMConfig

                labels = tuple(labels or ("O", "B-KEY", "I-KEY", "B-VALUE", "I-VALUE"))
                indexer = LayoutDocumentIndexer(
                    labels=labels, config=LayoutLMConfig.base(num_labels=len(labels)),
                    device=device)
        self.indexer = indexer
        if isinstance(ocr_engine, str):  # a registry engine by name, as YAML gives it
            from marie_tpu_torch.ocr.util import get_known_ocr_engines

            ocr_engine = get_known_ocr_engines(device=device, engine=ocr_engine)[ocr_engine]
        self.ocr_engine = ocr_engine  # runs OCR when a document has no words

    @requests(on="/ner/extract")
    @safely_encoded
    def extract(self, docs: DocumentArray, parameters: Dict[str, Any], **kwargs):
        pages = []
        for doc in docs:
            words = doc.tags.get("words")
            boxes = doc.tags.get("boxes")
            image = np.asarray(doc.tensor).astype(np.uint8) if doc.tensor is not None else None
            if (not words) and image is not None and self.ocr_engine is not None:
                result = self.ocr_engine.extract([image])[0]
                words = [w["text"] for w in result["words"]]
                boxes = [w["box"] for w in result["words"]]
            if words and boxes and self.text_layout is not None:
                xyxy, scale = reading_order_boxes(boxes, image)
                order = self.text_layout.order(xyxy, scale=scale)
                words = [words[j] for j in order]
                boxes = [boxes[j] for j in order]
            pages.append(PageInput(words or [], boxes or [], image))
        results = self.indexer.index(pages)
        for doc, res in zip(docs, results):
            doc.tags["indexer"] = res
        if self.storage_enabled:
            from marie_tpu_torch.api.docs import StorageDoc

            ref_id = str(parameters.get("ref_id", docs[0].id if len(docs) else ""))
            self.store(
                ref_id=ref_id, ref_type=str(parameters.get("ref_type", "doc")),
                store_mode="content",
                docs=[StorageDoc(content=results, tags={
                    "action": "ner", "index": -1, "type": "ner_results", "ttl": 48 * 60,
                    "checksum": ref_id})],
            )
        return {"status": "succeeded", "entities": results}
