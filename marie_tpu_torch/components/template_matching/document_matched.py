"""OCR-conditioned template matching (port of ``marie_tpu/components/
template_matching/document_matched.py``, host code): a definition may
carry anchor ``text``; a visual match is kept only when the OCR words in
its region hold that text."""

from typing import Any, Dict, List, Sequence

import numpy as np

from marie_tpu_torch.components.template_matching.base import (
    BaseTemplateMatcher,
    TemplateMatchResult,
)


def _edit_distance(a: str, b: str) -> int:
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def _text_similarity(a: str, b: str) -> float:
    a, b = a.lower().strip(), b.lower().strip()
    if not a or not b:
        return 0.0
    return 1.0 - _edit_distance(a, b) / max(len(a), len(b))


class OcrConditionedMatcher(BaseTemplateMatcher):
    """Wraps any visual matcher; confirms its matches against OCR words.

    A match whose template defines anchor ``text`` is kept only when the
    OCR words overlapping its region (grown by ``margin``) contain the
    anchor with similarity >= ``text_threshold``; a confirmed match's
    score is blended with that similarity."""

    def __init__(self, matcher: BaseTemplateMatcher, text_threshold: float = 0.66,
                 margin: int = 8, **kwargs):
        super().__init__(**kwargs)
        self.matcher = matcher
        self.text_threshold = text_threshold
        self.margin = margin

    def add_template(self, label, template, text=None) -> None:
        super().add_template(label, template, text)
        self.matcher.add_template(label, template, text)

    def match(self, frames: Sequence[np.ndarray], **kwargs):
        return self.matcher.match(frames, **kwargs)

    def match_with_ocr(
        self,
        frames: Sequence[np.ndarray],
        ocr_results: Sequence[Dict[str, Any]],
        **kwargs,
    ) -> List[TemplateMatchResult]:
        """``ocr_results``: one OCR page result per frame (the engine's
        ``{words: [{text, box: xywh}, ...]}``)."""
        text_by_label = {t["label"]: t.get("text") for t in self._templates}
        results = self.matcher.match(frames, **kwargs)
        out: List[TemplateMatchResult] = []
        for m in results:
            anchor = text_by_label.get(m.label)
            if not anchor:
                out.append(m)  # a purely visual template
                continue
            words = (ocr_results[m.frame_index].get("words", [])
                     if m.frame_index < len(ocr_results) else [])
            region_words = [w for w in words
                            if self._overlaps(m.bbox, w.get("box", [0, 0, 0, 0]))]
            best = 0.0
            anchor_tokens = anchor.split()
            for i in range(len(region_words)):
                for span in range(1, len(anchor_tokens) + 1):
                    cand = " ".join(w["text"] for w in region_words[i:i + span])
                    best = max(best, _text_similarity(cand, anchor))
            if best >= self.text_threshold:
                m.score = 0.5 * m.score + 0.5 * best
                m.similarity = best
                out.append(m)
        return out

    def _overlaps(self, bbox: List[int], word_box: Sequence[float]) -> bool:
        x, y, w, h = bbox
        wx, wy, ww, wh = word_box
        m = self.margin
        return not (wx + ww < x - m or wx > x + w + m or wy + wh < y - m or wy > y + h + m)
