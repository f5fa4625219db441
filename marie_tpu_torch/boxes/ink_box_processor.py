"""InkBoxProcessor — weight-free word detection on the device (port of
``marie_tpu/boxes/ink_box_processor.py``): Otsu binarisation, a
morphological closing that joins characters into words, then the
run-domain connected components and their boxes.

The closing is ``lax.reduce_window(max, "SAME")`` in the JAX version: the
window is padded with -inf, ``(w - 1) // 2`` before and ``w // 2`` after,
so that past the border nothing counts (the erosion then keeps ink at the
border).  ``F.max_pool2d`` pads symmetrically, so the padding is written
out here and the pool runs unpadded, which gives the same windows for odd
and even sizes.
"""

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from marie_tpu_torch.boxes.box_processor import BoxProcessor, fit_page
from marie_tpu_torch.ops.connected_components import component_boxes_runs_cc
from marie_tpu_torch.preprocess.buckets import BucketSpec
from marie_tpu_torch.preprocess.ops import normalize_page, otsu_binarize, to_grayscale
from marie_tpu_torch.utils.device import resolve_device


def max_pool_same(m: torch.Tensor, wy: int, wx: int) -> torch.Tensor:
    """[H, W] bool -> ``reduce_window(max, (wy, wx), stride 1, "SAME")``
    of it as float32 with -inf padding, > 0."""
    x = F.pad(m.to(torch.float32)[None, None],
              ((wx - 1) // 2, wx // 2, (wy - 1) // 2, wy // 2), value=float("-inf"))
    return F.max_pool2d(x, (wy, wx), stride=1)[0, 0] > 0


@torch.no_grad()
def ink_detect(page_u8: torch.Tensor, join_x: int, join_y: int, max_components: int):
    """[H, W, 3] uint8 page -> component stats of its ink, joined by a
    (``join_y``, ``join_x``) closing (the JAX ``_ink_detect_jit``)."""
    ink = otsu_binarize(to_grayscale(normalize_page(page_u8)))
    if join_x > 1 or join_y > 1:
        dil = max_pool_same(ink, join_y, join_x)
        joined = ~max_pool_same(~dil, join_y, join_x)  # closing contains the ink
    else:
        joined = ink
    # closed ink words sit far under the 64-run row budget
    return component_boxes_runs_cc(joined, ink.to(torch.float32), max_components,
                                   max_runs_per_row=64)


class InkBoxProcessor(BoxProcessor):
    """Deterministic word boxes without weights (the JAX package's
    ``InkBoxProcessor``), on ``device`` (the card unless the caller asks
    for the CPU)."""

    def __init__(
        self,
        join_x: int = 9,
        join_y: int = 1,
        min_area: int = 8,
        max_components: int = 1024,
        bucket_spec: Optional[BucketSpec] = None,
        *,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.join_x = join_x
        self.join_y = join_y
        self.min_area = min_area
        self.max_components = max_components
        self.buckets = bucket_spec or BucketSpec()

    def detect_words(self, image: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        boxes, scores, _, _ = self.detect_with_page(image)
        return boxes, scores

    def detect_with_page(self, image: np.ndarray):
        """(boxes_xywh [N, 4] in the page's coordinates, scores [N] (ones),
        the bucket-padded [bh, bw, 3] uint8 page on the device, scale): the
        device page and its scale are what a recogniser's
        ``recognize_dispatch`` crops from.  A [H, W] page is taken as
        gray RGB."""
        h, w = image.shape[:2]
        page_dev, scale = fit_page(image, self.buckets, self.device)
        with record_function("marie.detect"):
            stats = ink_detect(page_dev, self.join_x, self.join_y, self.max_components)
        stats = {k: v.cpu().numpy() for k, v in stats.items()}
        boxes = stats["boxes"] / scale
        keep = stats["valid"] & (stats["areas"] >= self.min_area)
        boxes = boxes[keep]
        xywh = np.stack(
            [boxes[:, 0], boxes[:, 1], boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1]],
            axis=-1,
        )
        inside = (xywh[:, 0] < w) & (xywh[:, 1] < h)
        xywh = xywh[inside]
        xywh[:, 2] = np.minimum(xywh[:, 2], w - xywh[:, 0])
        xywh[:, 3] = np.minimum(xywh[:, 3], h - xywh[:, 1])
        scores = np.ones((len(xywh),), np.float32)
        return xywh, scores, page_dev, scale
