"""Box overlap/merge utilities (copy of ``marie_tpu/utils/overlap.py``,
host numpy).  Boxes are xywh unless noted.
"""

from typing import List, Sequence, Tuple

import numpy as np


def merge_bboxes_as_block(boxes: Sequence[Sequence[float]]) -> List[int]:
    """Union of xywh boxes as one xywh block."""
    arr = np.asarray(boxes, dtype=np.float64)
    x0 = arr[:, 0].min()
    y0 = arr[:, 1].min()
    x1 = (arr[:, 0] + arr[:, 2]).max()
    y1 = (arr[:, 1] + arr[:, 3]).max()
    return [int(x0), int(y0), int(x1 - x0), int(y1 - y0)]


def find_overlap_vertical(
    box: Sequence[float], candidates: Sequence[Sequence[float]]
) -> Tuple[List[List[float]], List[int], List[float]]:
    """Boxes whose y-interval overlaps ``box``'s (reference semantics):
    returns (overlapping boxes, their indexes, y-interval IoU scores)."""
    if len(candidates) == 0:
        return [], [], []
    arr = np.asarray(candidates, dtype=np.float64)
    y0, y1 = box[1], box[1] + box[3]
    c0 = arr[:, 1]
    c1 = arr[:, 1] + arr[:, 3]
    inter = np.maximum(0.0, np.minimum(y1, c1) - np.maximum(y0, c0))
    union = (y1 - y0) + (c1 - c0) - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        scores = np.where(union > 0, inter / union, 0.0)
    idx = np.nonzero(inter > 0)[0]
    return [arr[i].tolist() for i in idx], idx.tolist(), [float(scores[i]) for i in idx]


def find_overlap_horizontal(
    box: Sequence[float], candidates: Sequence[Sequence[float]]
) -> Tuple[List[List[float]], List[int], List[float]]:
    """Boxes whose x-interval overlaps ``box``'s (reference semantics):
    returns (overlapping boxes, their indexes, x-interval IoU scores)."""
    if len(candidates) == 0:
        return [], [], []
    arr = np.asarray(candidates, dtype=np.float64)
    x0, x1 = box[0], box[0] + box[2]
    c0 = arr[:, 0]
    c1 = arr[:, 0] + arr[:, 2]
    inter = np.maximum(0.0, np.minimum(x1, c1) - np.maximum(x0, c0))
    union = (x1 - x0) + (c1 - c0) - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        scores = np.where(union > 0, inter / union, 0.0)
    idx = np.nonzero(inter > 0)[0]
    return [arr[i].tolist() for i in idx], idx.tolist(), [float(scores[i]) for i in idx]


def compute_iou(box_a: Sequence[float], box_b: Sequence[float]) -> float:
    """IoU of two xyxy boxes."""
    ax0, ay0, ax1, ay1 = box_a
    bx0, by0, bx1, by1 = box_b
    ix = max(0.0, min(ax1, bx1) - max(ax0, bx0))
    iy = max(0.0, min(ay1, by1) - max(ay0, by0))
    inter = ix * iy
    union = (ax1 - ax0) * (ay1 - ay0) + (bx1 - bx0) * (by1 - by0) - inter
    return inter / union if union > 0 else 0.0
