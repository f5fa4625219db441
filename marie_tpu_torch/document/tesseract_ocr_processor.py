"""Tesseract recogniser shell (port of
``marie_tpu/document/tesseract_ocr_processor.py``).

The JAX shell is available where ``pytesseract`` imports, and reads each
fragment through PIL.  The port imports neither: it runs the ``tesseract``
binary that ``pytesseract`` drives (``--psm 8``, the fragment as a PNG from
``utils/image_io.py``) and is available where that binary is on the
``PATH``.  Where it is not (the card's machine), ``is_available()`` is
False, a config that names the processor still loads, and the voting
engine skips it.
"""

import os
import shutil
import subprocess
import tempfile
from typing import Any, Dict, List, Sequence

import numpy as np

from marie_tpu_torch.document.ocr_processor import OcrProcessor
from marie_tpu_torch.logging_core import MarieLogger
from marie_tpu_torch.utils.image_io import write_png


class TesseractOcrProcessor(OcrProcessor):
    def __init__(self, work_dir: str = "/tmp/icr", lang: str = "eng", **kwargs):
        self.work_dir = work_dir
        self.logger = MarieLogger(type(self).__name__)
        self.lang = lang
        self._binary = shutil.which("tesseract")

    def is_available(self) -> bool:
        return self._binary is not None

    def recognize_from_fragments(
        self, fragments: Sequence[np.ndarray]
    ) -> List[Dict[str, Any]]:
        if not self.is_available():
            raise RuntimeError(
                "the tesseract binary is not on the PATH; TesseractOcrProcessor is "
                "unavailable in this environment"
            )
        out = []
        with tempfile.TemporaryDirectory() as tmp:
            for i, frag in enumerate(fragments):
                path = os.path.join(tmp, f"{i}.png")
                write_png(path, np.asarray(frag, np.uint8))
                text = subprocess.run(
                    [self._binary, path, "stdout", "-l", self.lang, "--psm", "8"],
                    capture_output=True, text=True, check=True,
                ).stdout.strip()
                out.append({"text": text, "confidence": 0.9 if text else 0.0})
        return out
