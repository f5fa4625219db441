"""Composite matcher (port of ``marie_tpu/components/template_matching/
composite.py``): the union of child matchers, overlapping same-label
matches on a page deduplicated, best score first."""

from typing import List, Sequence

from marie_tpu_torch.components.template_matching.base import (
    BaseTemplateMatcher,
    TemplateMatchResult,
)
from marie_tpu_torch.utils.overlap import compute_iou


class CompositeTemplateMatcher(BaseTemplateMatcher):
    def __init__(self, matchers: Sequence[BaseTemplateMatcher], **kwargs):
        super().__init__(**kwargs)
        self.matchers = list(matchers)

    def add_template(self, label, template, text=None):
        for m in self.matchers:
            m.add_template(label, template, text)

    def match(self, frames, score_threshold: float = 0.8, **kwargs) -> List[TemplateMatchResult]:
        all_matches: List[TemplateMatchResult] = []
        for m in self.matchers:
            all_matches.extend(m.match(frames, score_threshold, **kwargs))
        # dedup overlapping same-label matches, best score wins
        all_matches.sort(key=lambda r: -r.score)
        kept: List[TemplateMatchResult] = []
        for cand in all_matches:
            cx = [cand.bbox[0], cand.bbox[1], cand.bbox[0] + cand.bbox[2],
                  cand.bbox[1] + cand.bbox[3]]
            dup = False
            for k in kept:
                if k.label != cand.label or k.frame_index != cand.frame_index:
                    continue
                kx = [k.bbox[0], k.bbox[1], k.bbox[0] + k.bbox[2], k.bbox[1] + k.bbox[3]]
                if compute_iou(cx, kx) > 0.5:
                    dup = True
                    break
            if not dup:
                kept.append(cand)
        return kept
