"""Rotated-box IoU (port of ``marie_tpu/ops/rotated_iou.py``).

Two convex quadrilaterals intersect in a polygon of at most 8 vertices
(each of the 4 clipping half-planes adds at most one), so the
Sutherland–Hodgman clip runs a fixed 4 passes over an 8-slot vertex
buffer with a vertex count, vectorised over every pair at once: no
data-dependent loop and no host sync.

Rotated boxes are ``(cx, cy, w, h, angle)`` with the angle in degrees,
counter-clockwise (detectron2's ``RotatedBoxes``).
"""

import math

import torch

from marie_tpu_torch.utils.device import resolve_device

_MAX_VERTS = 8
_EPS = 1e-8


def cos_sin_degrees(ang: torch.Tensor):
    """(cos, sin) of angles in degrees, as float32: the float32 radians
    (as JAX's ``deg2rad``), their cosine and sine in float64, rounded once.
    The card's float32 ``cos``/``sin`` are a few ulps off the CPU's; these
    are the same on both."""
    theta = (ang * (math.pi / 180.0)).to(torch.float64)
    return torch.cos(theta).to(ang.dtype), torch.sin(theta).to(ang.dtype)


def box_corners(boxes: torch.Tensor) -> torch.Tensor:
    """``[..., 5]`` rotated boxes -> ``[..., 4, 2]`` corners, wound
    counter-clockwise."""
    cx, cy, w, h, ang = boxes.unbind(-1)
    c, s = cos_sin_degrees(ang)
    dx, dy = w / 2.0, h / 2.0
    lx = torch.stack([dx, -dx, -dx, dx], dim=-1)  # [..., 4]
    ly = torch.stack([dy, dy, -dy, -dy], dim=-1)
    x = c[..., None] * lx - s[..., None] * ly + cx[..., None]
    y = s[..., None] * lx + c[..., None] * ly + cy[..., None]
    return torch.stack([x, y], dim=-1)


def _ring(n: torch.Tensor):
    """(valid [P, 8], next slot [P, 8]) of buffers holding ``n`` vertices."""
    idx = torch.arange(_MAX_VERTS, device=n.device)[None, :]
    valid = idx < n[:, None]
    nxt = torch.where(idx + 1 >= n[:, None], 0, idx + 1)
    return valid, nxt


def _clip_halfplane(pts, n, e1, e2):
    """Clip polygons ``pts`` [P, 8, 2] (``n`` [P] vertices each) to the
    half-plane left of the directed edges ``e1`` -> ``e2`` [P, 2]."""
    edge = e2 - e1
    rel = pts - e1[:, None, :]
    d = edge[:, None, 0] * rel[..., 1] - edge[:, None, 1] * rel[..., 0]
    valid, nxt = _ring(n)
    q = torch.gather(pts, 1, nxt[..., None].expand(-1, -1, 2))
    dq = torch.gather(d, 1, nxt)
    inside_p, inside_q = d >= 0, dq >= 0
    crosses = (inside_p != inside_q) & valid
    emit_p = inside_p & valid
    den = d - dq
    t = d / torch.where(den.abs() < _EPS, torch.full_like(den, _EPS), den)
    inter = pts + t[..., None] * (q - pts)
    # each edge emits [p?] then [intersection?]: slots by a running count
    counts = emit_p.to(torch.int64) + crosses.to(torch.int64)
    starts = torch.cumsum(counts, dim=1) - counts
    trash = _MAX_VERTS  # the slot past the buffer takes what is dropped
    pos_p = torch.where(emit_p, starts.clamp(max=trash), trash)
    pos_x = torch.where(crosses, (starts + emit_p.to(torch.int64)).clamp(max=trash), trash)
    out = torch.zeros(pts.shape[0], _MAX_VERTS + 1, 2, dtype=pts.dtype, device=pts.device)
    out.scatter_(1, pos_p[..., None].expand(-1, -1, 2), pts)
    out.scatter_(1, pos_x[..., None].expand(-1, -1, 2), inter)
    return out[:, :_MAX_VERTS], counts.sum(dim=1)


def _poly_area(pts: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Shoelace area of the first ``n`` points of each 8-slot buffer."""
    valid, nxt = _ring(n)
    x, y = pts[..., 0], pts[..., 1]
    xn, yn = torch.gather(x, 1, nxt), torch.gather(y, 1, nxt)
    cross = torch.where(valid, x * yn - xn * y, torch.zeros_like(x))
    return cross.sum(dim=1).abs() / 2.0


def _intersection_area(box_a: torch.Tensor, box_b: torch.Tensor) -> torch.Tensor:
    """Intersection areas of pairs of rotated boxes [P, 5] -> [P]."""
    ca, cb = box_corners(box_a), box_corners(box_b)
    p = box_a.shape[0]
    pts = torch.zeros(p, _MAX_VERTS, 2, dtype=box_a.dtype, device=box_a.device)
    pts[:, :4] = ca
    n = torch.full((p,), 4, dtype=torch.int64, device=box_a.device)
    for k in range(4):
        pts, n = _clip_halfplane(pts, n, cb[:, k], cb[:, (k + 1) % 4])
    return torch.where(n >= 3, _poly_area(pts, n), torch.zeros((), dtype=pts.dtype,
                                                                device=pts.device))


def _iou(box_a: torch.Tensor, box_b: torch.Tensor) -> torch.Tensor:
    inter = _intersection_area(box_a, box_b)
    union = box_a[:, 2] * box_a[:, 3] + box_b[:, 2] * box_b[:, 3] - inter
    return torch.where(union > _EPS, inter / union, torch.zeros_like(union))


def rotated_iou(box_a: torch.Tensor, box_b: torch.Tensor, *, device="cuda") -> torch.Tensor:
    """IoU of two rotated boxes ``[5]`` each (or two stacks ``[P, 5]``,
    pair by pair) on ``device``."""
    dev = resolve_device(device)
    a = torch.as_tensor(box_a, dtype=torch.float32).to(dev)
    b = torch.as_tensor(box_b, dtype=torch.float32).to(dev)
    out = _iou(a.reshape(-1, 5), b.reshape(-1, 5))
    return out.reshape(a.shape[:-1])


def pairwise_rotated_iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor, *,
                         device="cuda") -> torch.Tensor:
    """``[N, 5]`` x ``[M, 5]`` -> the ``[N, M]`` IoU matrix on ``device``
    (the card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    a = torch.as_tensor(boxes_a, dtype=torch.float32).to(dev)
    b = torch.as_tensor(boxes_b, dtype=torch.float32).to(dev)
    n, m = a.shape[0], b.shape[0]
    pa = a[:, None, :].expand(n, m, 5).reshape(-1, 5)
    pb = b[None, :, :].expand(n, m, 5).reshape(-1, 5)
    return _iou(pa, pb).reshape(n, m)
