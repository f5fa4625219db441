"""Cloud OCR processor shells (port of
``marie_tpu/document/cloud_ocr_processors.py``): Google Vision, Azure
Vision and AWS Textract, each never available and raising on use, so that
a config naming one loads and the voting engine skips it.  A deployment
that wires real credentials subclasses one and implements
``recognize_from_fragments``.
"""

from typing import Any, Dict, List, Sequence

import numpy as np

from marie_tpu_torch.document.ocr_processor import OcrProcessor
from marie_tpu_torch.logging_core import MarieLogger


class _CloudOcrShell(OcrProcessor):
    """Common shell: never available, raises on use."""

    _SERVICE = "cloud"

    def __init__(self, work_dir: str = "/tmp/icr", **kwargs):
        self.work_dir = work_dir
        self.logger = MarieLogger(type(self).__name__)

    def is_available(self) -> bool:
        return False

    def recognize_from_fragments(
        self, fragments: Sequence[np.ndarray], **kwargs
    ) -> List[Dict[str, Any]]:
        raise NotImplementedError(
            f"{self._SERVICE} OCR is not implemented; subclass and wire "
            "credentials to use it"
        )


class GoogleVisionOcrProcessor(_CloudOcrShell):
    _SERVICE = "Google Vision"


class AzureVisionOcrProcessor(_CloudOcrShell):
    _SERVICE = "Azure Vision"


class AwsTextractOcrProcessor(_CloudOcrShell):
    _SERVICE = "AWS Textract"
