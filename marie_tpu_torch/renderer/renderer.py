"""Result renderers — OCR results -> artifacts (copy of
``marie_tpu/renderer/renderer.py``; upstream marie's ``ResultRenderer``):
``render(frames, results, output_filename)`` over per-page result dicts
(meta/words/lines, xywh boxes), and the streamed ``begin``/``feed``/
``finish`` that the extract pipeline's render thread drives.
"""

from abc import ABC, abstractmethod
from typing import Any, Dict, List, Optional

import numpy as np

from marie_tpu_torch.logging_core import MarieLogger


class ResultRenderer(ABC):
    def __init__(self, config: Optional[Dict[str, Any]] = None):
        self.config = config or {}
        self.logger = MarieLogger(type(self).__name__)

    @property
    @abstractmethod
    def name(self) -> str: ...

    @abstractmethod
    def render_page(
        self, image: np.ndarray, result: Dict[str, Any], page_index: int
    ) -> Any:
        """Render one page; return the page artifact."""

    def render(
        self,
        frames: List[np.ndarray],
        results: List[Dict[str, Any]],
        output_filename: str,
    ) -> None:
        """Render all pages and write the combined artifact to disk."""
        pages = [
            self.render_page(img, res, i)
            for i, (img, res) in enumerate(zip(frames, results))
        ]
        self.write(pages, output_filename)

    @abstractmethod
    def write(self, pages: List[Any], output_filename: str) -> None: ...

    # -- incremental API -------------------------------------------------
    # ExtractPipeline streams OCR results per page-group so the CPU-bound
    # per-page rendering (``render_page``) runs while the device executes
    # later groups; ``finish`` pays only the final combine/write.  The
    # default implementation works for every renderer whose per-page cost
    # lives in ``render_page`` (all in-tree renderers after the
    # PdfRenderer encode move).
    def begin(self, output_filename: str) -> None:
        self._inc_out = output_filename
        self._inc_pages: List[Any] = []

    def feed(
        self,
        frames: List[np.ndarray],
        results: List[Dict[str, Any]],
        start_index: int = 0,
    ) -> None:
        for k, (img, res) in enumerate(zip(frames, results)):
            self._inc_pages.append(self.render_page(img, res, start_index + k))

    def finish(self) -> None:
        self.write(self._inc_pages, self._inc_out)
        self._inc_pages = []

    @staticmethod
    def check_format_xywh(result: Dict[str, Any], convert: bool = True) -> None:
        """Ensure word boxes are xywh; convert in place from xyxy if the
        result's meta says so."""
        fmt = result.get("meta", {}).get("format", "xywh")
        if fmt == "xyxy" and convert:
            for word in result.get("words", []):
                x0, y0, x1, y1 = word["box"]
                word["box"] = [x0, y0, x1 - x0, y1 - y0]
            result["meta"]["format"] = "xywh"
