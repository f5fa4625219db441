"""Template matching base (port of ``marie_tpu/components/template_matching/
base.py``, a plain class): labelled template snippets matched over pages;
a definition carries (label, template image, optional anchor text).

Template files are read with :mod:`marie_tpu_torch.utils.image_io` (PNG
and TIFF; the card has no PIL) and turned RGB as PIL's ``convert("RGB")``
turns a gray page; another format raises ``ValueError`` naming it."""

import dataclasses
from abc import ABC, abstractmethod
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from marie_tpu_torch.logging_core import MarieLogger
from marie_tpu_torch.ops.nms import nms


@dataclasses.dataclass
class TemplateMatchResult:
    bbox: List[int]  # xywh in page coords
    label: str
    score: float
    similarity: float
    frame_index: int = 0


def top_peaks(score: torch.Tensor, th: int, tw: int, max_peaks: int):
    """The ``max_peaks`` best positions of a score map [Ho, Wo] on its
    device, as the JAX matchers take them: ``jax.lax.top_k`` order (by
    descending score, ties to the lower flat index: a stable sort), each
    a (th, tw) box [x, y, x + tw, y + th] in map cells, greedy NMS at IoU
    0.3.  Returns (boxes [K, 4], scores [K], keep [K]) on the host."""
    flat = score.reshape(-1)
    idx = torch.argsort(-flat, stable=True)[:max_peaks]
    scores = flat[idx]
    w_out = score.shape[1]
    ys = (idx // w_out).to(torch.float32)
    xs = (idx % w_out).to(torch.float32)
    boxes = torch.stack([xs, ys, xs + tw, ys + th], dim=-1)
    keep, _ = nms(boxes, scores, iou_threshold=0.3, device=score.device)
    return boxes.cpu().numpy(), scores.cpu().numpy(), keep.cpu().numpy()


def read_template(path: str) -> np.ndarray:
    """A template file as uint8 RGB [H, W, 3], as the JAX matcher's
    ``Image.open(path).convert("RGB")`` gives it: PNG (alpha dropped), a
    TIFF's first page, baseline JPEG or BMP, known by the file's first
    bytes (:func:`marie_tpu_torch.utils.image_io.read_image`)."""
    from marie_tpu_torch.utils.image_io import drop_alpha, read_image

    img = drop_alpha(read_image(path))
    return np.stack([img] * 3, axis=-1) if img.ndim == 2 else img


class BaseTemplateMatcher(ABC):
    def __init__(self, **kwargs):
        self.logger = MarieLogger(type(self).__name__)
        self._templates: List[Dict[str, Any]] = []

    def add_template(self, label: str, template: np.ndarray, text: Optional[str] = None) -> None:
        self._templates.append({"label": label, "image": template, "text": text})

    def load_definitions(self, definitions: Sequence[Dict[str, Any]]) -> None:
        """Definitions: [{label, template (array | path), text?}]."""
        for d in definitions:
            tpl = d["template"]
            if isinstance(tpl, str):
                tpl = read_template(tpl)
            self.add_template(d["label"], np.asarray(tpl), d.get("text"))

    @abstractmethod
    def match(
        self,
        frames: Sequence[np.ndarray],
        score_threshold: float = 0.8,
        max_matches_per_template: int = 5,
    ) -> List[TemplateMatchResult]: ...

    def run(self, frames, **kwargs) -> List[TemplateMatchResult]:
        return self.match(frames, **kwargs)
