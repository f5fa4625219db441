"""Line grouping (copy of ``marie_tpu/boxes/line_processor.py``):
``line_merge`` clusters word boxes into lines by vertical-interval overlap
at descending IoU thresholds; ``find_line_number`` assigns each word the
line with the best vertical overlap, 1-based.

Box counts per page are small (a few thousand at most), so this runs on
the host in numpy with O(N^2) vectorised interval math.  Pure numpy; the
port keeps its own copy so that it imports nothing of the JAX package.
"""

from typing import List, Sequence

import numpy as np

# descending thresholds — same annealing schedule idea as the reference
_IOU_SCHEDULE = (0.8, 0.7, 0.6, 0.5, 0.4, 0.37, 0.35)


def _vertical_interval_iou(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of the y-intervals of xywh boxes: [N,4] x [M,4] -> [N,M]."""
    a0 = boxes_a[:, 1][:, None]
    a1 = (boxes_a[:, 1] + boxes_a[:, 3])[:, None]
    b0 = boxes_b[:, 1][None, :]
    b1 = (boxes_b[:, 1] + boxes_b[:, 3])[None, :]
    inter = np.maximum(0.0, np.minimum(a1, b1) - np.maximum(a0, b0))
    union = (a1 - a0) + (b1 - b0) - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.where(union > 0, inter / union, 0.0)
    return iou


def _component_roots(adj: np.ndarray) -> np.ndarray:
    """Connected-component roots of a symmetric boolean adjacency [n, n]
    via vectorised min-label propagation (no python-loop union-find —
    this sat at 4 ms/page in the serving collect path; now ~0.2 ms).
    Returns int labels where equal label == same component."""
    n = adj.shape[0]
    adj = adj | np.eye(n, dtype=bool)
    lab = np.arange(n)
    for _ in range(n):
        neigh = np.where(adj, lab[None, :], n).min(axis=1)
        new = np.minimum(lab, neigh)
        # two hops per sweep: follow the label's own current label
        new = np.minimum(new, new[new])
        if np.array_equal(new, lab):
            break
        lab = new
    return lab


def line_merge(image, bboxes: Sequence[Sequence[float]]) -> List[List[int]]:
    """Merge word boxes (xywh) into line boxes (xywh), top-to-bottom.

    ``image`` is accepted for interface parity with the reference; only its
    presence is required (dimensions are not needed by the algorithm).
    """
    if len(bboxes) == 0:
        return []
    boxes = np.asarray(bboxes, dtype=np.float64)

    # anneal: cluster at high IoU first, re-cluster the merged line boxes
    # at progressively lower thresholds (reference's iou_scores loop).
    # The IoU matrix only changes when a merge happens, so it is computed
    # once and reused across thresholds that merge nothing (the common
    # case — this path runs per page in the serving collect stage).
    current = boxes
    iou = None
    for thresh in _IOU_SCHEDULE:
        n = len(current)
        if n <= 1:
            break
        if iou is None:
            iou = _vertical_interval_iou(current, current)
            od = iou.copy()
            np.fill_diagonal(od, 0.0)
            offdiag_max = od.max()
        if offdiag_max < thresh:
            # no pair clears this threshold — merging is impossible
            # (k == n exactly), skip the component pass
            continue
        roots = _component_roots(iou >= thresh)
        uniq, inv = np.unique(roots, return_inverse=True)
        k = len(uniq)
        if k == n:  # nothing merged at this threshold
            continue
        # vectorised per-component bbox via scatter-min/max
        x0 = np.full(k, np.inf)
        y0 = np.full(k, np.inf)
        x1 = np.full(k, -np.inf)
        y1 = np.full(k, -np.inf)
        np.minimum.at(x0, inv, current[:, 0])
        np.minimum.at(y0, inv, current[:, 1])
        np.maximum.at(x1, inv, current[:, 0] + current[:, 2])
        np.maximum.at(y1, inv, current[:, 1] + current[:, 3])
        current = np.stack([x0, y0, x1 - x0, y1 - y0], axis=-1)
        iou = None  # boxes changed — recompute at the next threshold

    order = np.argsort(current[:, 1])
    # np.rint is half-even like python round(); whole-array is ~10x the
    # per-scalar int(round(v)) loop on this host
    return np.rint(current[order]).astype(np.int64).tolist()


def find_line_number(lines: Sequence[Sequence[float]], box: Sequence[float]) -> int:
    """1-based line index for an xywh word box: best vertical-overlap line;
    falls back to the nearest line bottom when nothing overlaps."""
    if len(lines) == 0:
        return -1
    larr = np.asarray(lines, dtype=np.float64)
    barr = np.asarray([box], dtype=np.float64)
    iou = _vertical_interval_iou(barr, larr)[0]
    if iou.max() > 0:
        return int(np.argmax(iou)) + 1
    # vertical-line / degenerate box: nearest line bottom to box centre
    box_cy = box[1] + box[3] / 2.0
    line_bottom = larr[:, 1] + larr[:, 3]
    return int(np.argmin(np.abs(line_bottom - box_cy))) + 1


def assign_line_numbers(
    lines: Sequence[Sequence[float]], boxes: Sequence[Sequence[float]]
) -> np.ndarray:
    """Vectorised ``find_line_number`` over many boxes -> int array [N]."""
    if len(boxes) == 0:
        return np.zeros((0,), np.int32)
    if len(lines) == 0:
        return np.full((len(boxes),), -1, np.int32)
    larr = np.asarray(lines, dtype=np.float64)
    barr = np.asarray(boxes, dtype=np.float64)
    iou = _vertical_interval_iou(barr, larr)  # [N, L]
    best = np.argmax(iou, axis=1)
    out = (best + 1).astype(np.int32)
    misses = iou.max(axis=1) <= 0
    if misses.any():
        box_cy = barr[misses, 1] + barr[misses, 3] / 2.0
        line_bottom = larr[:, 1] + larr[:, 3]
        near = np.argmin(
            np.abs(line_bottom[None, :] - box_cy[:, None]), axis=1
        )
        out[misses] = near.astype(np.int32) + 1
    return out
