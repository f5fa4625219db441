"""Axis-aligned box ops (port of ``marie_tpu/ops/box_ops.py``).
Boxes are float tensors ``[N, 4]`` in xyxy unless stated otherwise."""

import torch


def boxes_xywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    x, y, w, h = boxes.unbind(-1)
    return torch.stack([x, y, x + w, y + h], dim=-1)


def boxes_xyxy_to_xywh(boxes: torch.Tensor) -> torch.Tensor:
    x0, y0, x1, y1 = boxes.unbind(-1)
    return torch.stack([x0, y0, x1 - x0, y1 - y0], dim=-1)


def boxes_cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of xyxy boxes, clamped at zero. [..., 4] -> [...]."""
    w = torch.clamp(boxes[..., 2] - boxes[..., 0], min=0.0)
    h = torch.clamp(boxes[..., 3] - boxes[..., 1], min=0.0)
    return w * h


def _intersection(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    a = boxes_a[:, None, :]
    b = boxes_b[None, :, :]
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    return wh[..., 0] * wh[..., 1]


def box_iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU. [N, 4] x [M, 4] -> [N, M]."""
    inter = _intersection(boxes_a, boxes_b)
    union = box_area(boxes_a)[:, None] + box_area(boxes_b)[None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def box_intersection_over_min(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Pairwise intersection / min(area), the overlap the block merge uses."""
    inter = _intersection(boxes_a, boxes_b)
    min_area = torch.minimum(box_area(boxes_a)[:, None], box_area(boxes_b)[None, :])
    return torch.where(min_area > 0, inter / min_area, torch.zeros_like(inter))
