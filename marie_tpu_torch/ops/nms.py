"""Non-maximum suppression (port of ``marie_tpu/ops/nms.py``): a stable
sort by descending score with padded rows at ``-inf``, the pairwise IoU
matrix once, then the sequential greedy keep over ranks, a fixed trip
count of N small device ops with no host sync.  The keep mask comes back
in input order.

``rotated_nms`` runs the same greedy keep over the rotated-box IoU of
:mod:`marie_tpu_torch.ops.rotated_iou`."""

from typing import Optional, Tuple

import torch

from marie_tpu_torch.ops.box_ops import box_iou
from marie_tpu_torch.ops.rotated_iou import pairwise_rotated_iou
from marie_tpu_torch.utils.device import resolve_device


def nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float = 0.5,
    valid_mask: Optional[torch.Tensor] = None,
    max_outputs: Optional[int] = None,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS over xyxy boxes ``[N, 4]`` and scores ``[N]`` on
    ``device`` (the card unless the caller asks for the CPU).  Suppresses
    boxes with IoU > ``iou_threshold`` against a kept box; ``valid_mask``
    marks real rows; ``max_outputs`` keeps at most that many by score.  Returns (keep [N] bool in input order, order [N] int64
    indices by descending score, ties to the lower index)."""
    dev = resolve_device(device)
    boxes = torch.as_tensor(boxes).to(dev)
    scores = torch.as_tensor(scores).to(dev)
    n = boxes.shape[0]
    if valid_mask is None:
        valid_mask = torch.ones((n,), dtype=torch.bool, device=dev)
    valid_mask = torch.as_tensor(valid_mask).to(dev)
    neg_inf = torch.full_like(scores, float("-inf"))
    masked = torch.where(valid_mask, scores, neg_inf)
    order = torch.argsort(-masked, stable=True)
    iou = box_iou(boxes[order], boxes[order])
    keep = _suppress(iou, valid_mask[order], iou_threshold)
    if max_outputs is not None:
        rank = torch.cumsum(keep.to(torch.int32), dim=0) - 1
        keep = keep & (rank < max_outputs)
    out = torch.zeros((n,), dtype=torch.bool, device=dev)
    out[order] = keep
    return out, order


def _suppress(iou: torch.Tensor, valid: torch.Tensor, thresh: float) -> torch.Tensor:
    """Sequential-greedy suppression on a score-sorted IoU matrix: row i
    suppresses lower-ranked boxes only if box i is itself kept."""
    n = iou.shape[0]
    over = iou > thresh
    later = torch.arange(n, device=iou.device)[None, :] > torch.arange(n, device=iou.device)[:, None]
    over = over & later
    keep = valid.clone()
    for i in range(n):
        keep = keep & ~(over[i] & keep[i])
    return keep


def rotated_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float = 0.5,
    valid_mask: Optional[torch.Tensor] = None,
    max_outputs: Optional[int] = None,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS over rotated boxes ``[N, 5]`` (cx, cy, w, h, angle in
    degrees counter-clockwise), as :func:`nms` on ``device``."""
    dev = resolve_device(device)
    boxes = torch.as_tensor(boxes, dtype=torch.float32).to(dev)
    scores = torch.as_tensor(scores).to(dev)
    n = boxes.shape[0]
    if valid_mask is None:
        valid_mask = torch.ones((n,), dtype=torch.bool, device=dev)
    valid_mask = torch.as_tensor(valid_mask).to(dev)
    masked = torch.where(valid_mask, scores, torch.full_like(scores, float("-inf")))
    order = torch.argsort(-masked, stable=True)
    iou = pairwise_rotated_iou(boxes[order], boxes[order], device=dev)
    keep = _suppress(iou, valid_mask[order], iou_threshold)
    if max_outputs is not None:
        rank = torch.cumsum(keep.to(torch.int32), dim=0) - 1
        keep = keep & (rank < max_outputs)
    out = torch.zeros((n,), dtype=torch.bool, device=dev)
    out[order] = keep
    return out, order


def batched_nms(boxes, scores, class_ids, iou_threshold=0.5, valid_mask=None,
                device="cuda"):
    """Class-aware NMS on ``device``: each class's boxes are shifted to a
    disjoint region (by twice the largest coordinate, plus one) so that
    one plain NMS call never lets two classes suppress each other."""
    dev = resolve_device(device)
    boxes = torch.as_tensor(boxes).to(dev)
    max_coord = torch.max(torch.abs(boxes)) + 1.0
    offsets = torch.as_tensor(class_ids).to(dev).to(boxes.dtype)[:, None] * (2.0 * max_coord)
    return nms(boxes + offsets, scores, iou_threshold, valid_mask, device=dev)
