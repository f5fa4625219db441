"""MockOcrEngine — canned results for tests and serving dry runs (copy of
``marie_tpu/ocr/mock_ocr_engine.py``)."""

from typing import Any, Dict, List

from marie_tpu_torch.enums import CoordinateFormat, PSMode
from marie_tpu_torch.ocr.ocr_engine import _as_frame_list


class MockOcrEngine:
    """A deterministic fake extraction: one word per page quadrant."""

    def __init__(self, text: str = "mock"):
        self.text = text

    def extract(
        self,
        frames,
        pms_mode: PSMode = PSMode.SPARSE,
        coordinate_format: CoordinateFormat = CoordinateFormat.XYWH,
        regions=None,
        queue_id: str = "",
        **kwargs,
    ) -> List[Dict[str, Any]]:
        frames = _as_frame_list(frames)
        if regions:
            return [{"id": r["id"], "text": self.text, "confidence": 1.0, "words": []}
                    for r in regions]
        results = []
        for i, frame in enumerate(frames):
            h, w = frame.shape[0], frame.shape[1]
            words, lines = [], []
            for q, (qx, qy) in enumerate([(0, 0), (w // 2, 0), (0, h // 2), (w // 2, h // 2)]):
                box = [qx + w // 8, qy + h // 8, w // 4, h // 16]
                words.append({"id": q, "text": f"{self.text}{q}", "confidence": 1.0,
                              "box": box, "line": q + 1, "word_index": q})
                lines.append({"line": q + 1, "wordids": [q], "text": f"{self.text}{q}",
                              "bbox": box, "confidence": 1.0})
            results.append({
                "meta": {
                    "imageSize": {"width": int(w), "height": int(h)},
                    "page": i,
                    "lang": "en",
                    "lines": [wd["line"] for wd in words],
                    "lines_bboxes": [ln["bbox"] for ln in lines],
                    "format": coordinate_format.name.lower(),
                },
                "words": words,
                "lines": lines,
            })
        return results
