"""OverlayExecutor (port of ``marie_tpu/executor/overlay_executor.py``):
``/overlay/segment`` returns each document's page cleaned by the port's
``OverlayProcessor`` (on ``device``) and the mean of its overlay mask."""

from typing import Any, Dict

import numpy as np

from marie_tpu_torch.serve.executors import BaseExecutor
from marie_tpu_torch.serve.executors.decorators import requests
from marie_tpu_torch.types.docs import DocumentArray


class OverlayExecutor(BaseExecutor):
    def __init__(self, overlay_processor=None, device="cuda", **kwargs):
        super().__init__(**kwargs)
        if overlay_processor is None:
            from marie_tpu_torch.overlay import OverlayProcessor

            overlay_processor = OverlayProcessor(device=device)
        self.processor = overlay_processor

    @requests(on="/overlay/segment")
    def segment(self, docs: DocumentArray, parameters: Dict[str, Any], **kwargs):
        for doc in docs:
            if doc.tensor is None:
                continue
            frame = np.asarray(doc.tensor).astype(np.uint8)
            if frame.ndim == 2:
                frame = np.stack([frame] * 3, -1)
            _, mask, clean = self.processor.segment_frame(doc.id, frame)
            doc.tensor = clean
            doc.tags["overlay_mask_mean"] = float(mask.mean())
        return docs
