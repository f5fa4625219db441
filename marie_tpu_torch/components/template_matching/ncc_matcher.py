"""Normalised cross-correlation template matcher (port of
``marie_tpu/components/template_matching/ncc_matcher.py``): the template
is the kernel of one convolution over the page, box sums give each
window's variance, so the map is exact NCC; then the top peaks and NMS on
the device.

The window variance ``s2 - s1^2 / n`` cancels on near-white windows: in
float32 (the JAX version) its rounding error (a few ulps of ``s2``, ~1e-4
on a 1,000-pixel window) exceeds the variance of a paper background
whose pixels are 255 and 254, and the score of such a window is noise
that can pass any threshold (measured on registered pages: true NCC 0.10,
float32 0.83 in JAX and 1.78 in a float32 port), and the float32
correlation's own rounding over such a variance moves a score by up to
2 (measured).  Here the map is taken in float64 (box sums from integral
images) and rounded to float32: where float32 resolves a window, the
scores are the JAX version's; where it cannot, they are the true, small
ones."""

from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from marie_tpu_torch.components.template_matching.base import (
    BaseTemplateMatcher,
    TemplateMatchResult,
    top_peaks,
)
from marie_tpu_torch.utils.device import resolve_device


def ncc_map(page_gray: torch.Tensor, template_gray: torch.Tensor) -> torch.Tensor:
    """The NCC map [H - th + 1, W - tw + 1] of a page [H, W] and a template
    [th, tw] on the page's device (``_ncc_jit``): the correlation of the
    page with the zero-mean template over ``sqrt(local variance) * |t|``,
    the local variance ``max(s2 - s1^2 / n, 1e-6)`` from box sums; taken
    in float64 and rounded to float32."""
    th, tw = template_gray.shape
    t = template_gray.to(torch.float64)
    t = t - t.mean()
    t_norm = torch.sqrt(torch.sum(t * t) + 1e-6)
    x = page_gray.to(torch.float64)
    corr = F.conv2d(x[None, None], t[None, None])[0, 0]
    s1, s2 = box_sums64(x, th, tw), box_sums64(x * x, th, tw)
    local_var = torch.clamp(s2 - s1 * s1 / (th * tw), min=1e-6)
    return (corr / (torch.sqrt(local_var) * t_norm)).to(torch.float32)


def box_sums64(x: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """float64 sums of [H, W] over every VALID (th, tw) window, from the
    integral image."""
    s = F.pad(torch.cumsum(torch.cumsum(x.to(torch.float64), 0), 1), (1, 0, 1, 0))
    return s[th:, tw:] - s[:-th, tw:] - s[th:, :-tw] + s[:-th, :-tw]


def _gray01(img) -> np.ndarray:
    """A page or template as float32 gray: the channel mean, then / 255
    when it holds 0..255 values (the JAX matcher's host preparation)."""
    gray = np.asarray(img, np.float32)
    if gray.ndim == 3:
        gray = gray.mean(axis=-1)
    return gray / 255.0 if gray.max() > 1.5 else gray


class NCCTemplateMatcher(BaseTemplateMatcher):
    def __init__(self, max_peaks: int = 32, device="cuda", **kwargs):
        super().__init__(**kwargs)
        self.max_peaks = max_peaks
        self.device = resolve_device(device)

    def match(
        self,
        frames: Sequence[np.ndarray],
        score_threshold: float = 0.8,
        max_matches_per_template: int = 5,
    ) -> List[TemplateMatchResult]:
        out: List[TemplateMatchResult] = []
        templates = [(tpl, torch.from_numpy(_gray01(tpl["image"])).to(self.device))
                     for tpl in self._templates]
        for fi, frame in enumerate(frames):
            gray = torch.from_numpy(_gray01(frame)).to(self.device)
            for tpl, timg in templates:
                th, tw = timg.shape
                if th > gray.shape[0] or tw > gray.shape[1]:
                    continue
                with torch.inference_mode():
                    boxes, scores, keep = top_peaks(ncc_map(gray, timg), th, tw,
                                                    self.max_peaks)
                picked = 0
                for box, score, k in zip(boxes, scores, keep):
                    if not k or score < score_threshold:
                        continue
                    if picked >= max_matches_per_template:
                        break
                    x0, y0, x1, y1 = box
                    out.append(TemplateMatchResult(
                        bbox=[int(x0), int(y0), int(x1 - x0), int(y1 - y0)],
                        label=tpl["label"], score=float(score), similarity=float(score),
                        frame_index=fi))
                    picked += 1
        return out
