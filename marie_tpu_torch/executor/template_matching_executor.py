"""TemplateMatchingExecutor (port of
``marie_tpu/executor/template_matching_executor.py``): few-shot template
matching over the wire, on the port's matchers (on ``device``).

Endpoints:
  /template_matching/register — docs: tensor=template image,
      tags: {label, text?, bbox? [x,y,w,h] selector within the tensor}
  /document/matcher — docs: tensor=page frame; parameters:
      {score_threshold, max_matches_per_template}; results land in
      ``doc.tags["matches"]`` and the summary return payload.
"""

from typing import Any, Dict

import numpy as np

from marie_tpu_torch.serve.executors import BaseExecutor
from marie_tpu_torch.serve.executors.decorators import requests, safely_encoded
from marie_tpu_torch.types.docs import DocumentArray


class TemplateMatchingExecutor(BaseExecutor):
    def __init__(
        self,
        matcher=None,
        matcher_name: str = "vqnnf",
        definitions=None,
        device="cuda",
        **kwargs,
    ):
        super().__init__(**kwargs)
        if matcher is None:
            matcher = self._build_matcher(matcher_name, device)
        self.matcher = matcher
        if definitions:
            self.matcher.load_definitions(definitions)

    @staticmethod
    def _build_matcher(name: str, device="cuda"):
        from marie_tpu_torch.components.template_matching import (
            CompositeTemplateMatcher,
            DIMTemplateMatcher,
            NCCTemplateMatcher,
            VQNNFTemplateMatcher,
        )

        name = (name or "vqnnf").lower()
        if name == "vqnnf":
            return VQNNFTemplateMatcher(device=device)
        if name == "dim":
            return DIMTemplateMatcher(device=device)
        if name == "ncc":
            return NCCTemplateMatcher(device=device)
        if name == "composite":
            return CompositeTemplateMatcher(
                [VQNNFTemplateMatcher(device=device), NCCTemplateMatcher(device=device)]
            )
        raise ValueError(f"unknown matcher {name!r}")

    # ------------------------------------------------------------------
    @requests(on="/template_matching/register")
    @safely_encoded
    def register(self, docs: DocumentArray, parameters: Dict[str, Any],
                 **kwargs):
        """Register labelled template snippets ("selectors")."""
        registered = []
        for doc in docs:
            if doc.tensor is None:
                continue
            template = np.asarray(doc.tensor).astype(np.uint8)
            bbox = doc.tags.get("bbox")
            if bbox:
                x, y, w, h = (int(v) for v in bbox)
                template = template[y : y + h, x : x + w]
            label = str(doc.tags.get("label", f"template_{len(registered)}"))
            self.matcher.add_template(label, template, doc.tags.get("text"))
            registered.append(label)
        return {
            "status": "succeeded",
            "registered": registered,
            "total_templates": len(getattr(self.matcher, "_templates", [])),
        }

    @requests(on="/document/matcher")
    @safely_encoded
    def match(self, docs: DocumentArray, parameters: Dict[str, Any],
              **kwargs):
        """Match every registered template against the posted frames."""
        parameters = parameters or {}
        threshold = float(parameters.get("score_threshold", 0.5))
        max_matches = int(parameters.get("max_matches_per_template", 5))
        frames = []
        rows: list = []
        for doc in docs:
            if doc.tensor is None:
                rows.append(None)
                continue
            rows.append(len(frames))
            frames.append(np.asarray(doc.tensor).astype(np.uint8))
        if not frames:
            return {"error": "empty payload", "matches": []}
        results = self.matcher.match(
            frames,
            score_threshold=threshold,
            max_matches_per_template=max_matches,
        )
        by_frame: Dict[int, list] = {}
        payload = []
        for m in results:
            entry = {
                "frame_index": m.frame_index,
                "label": m.label,
                "bbox": [int(v) for v in m.bbox],
                "score": round(float(m.score), 4),
                "similarity": round(float(m.similarity), 4),
            }
            by_frame.setdefault(m.frame_index, []).append(entry)
            payload.append(entry)
        for doc, row in zip(docs, rows):
            doc.tags["matches"] = [] if row is None else by_frame.get(row, [])
        return {"status": "succeeded", "matches": payload}
