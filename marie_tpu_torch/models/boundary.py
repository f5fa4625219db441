"""Document-boundary corner regressor and the fit-to-page warp (port of
``marie_tpu/models/boundary.py``).

:class:`BoundaryNet` regresses the page quad's four corners from a small
RGB image: strided ``"SAME"`` 3x3 convolutions (flax pads a stride-2
convolution (0, 1) on an even side: ``models/pix2pix.py::SameConv2d``),
per-channel GroupNorm (``pix2pix.GroupNorm``: epsilon 1e-6, ``E[x^2] -
E[x]^2``), a global average pool and a two-layer MLP with a sigmoid.

The warps sample a page through a 3x3 homography.  Its 8x8 solve is
ill-conditioned in float32 at page-pixel coordinates (terms near 1e7), and
every solver rounds it its own way, so it runs on the host in float32
(:func:`homography_from_points`, the same bits for the CPU and the card)
and only the per-pixel work runs on the device.  The boundary trainer's
scans are the exception (:func:`composite_scans`): a step's B scans are
solved together on the device (``torch.linalg.solve_ex`` over [B, 8, 8]) at
the regressor's small canvas: off the quads' edges a pixel moves by at most
a grey level between solvers, and a pixel centre on an edge falls inside or
out by the solver's last bit.
"""

from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from marie_tpu_torch.models.configs import BoundaryConfig
from marie_tpu_torch.models.pix2pix import GroupNorm, SameConv2d
from marie_tpu_torch.preprocess.ops import _bilinear_hwc, fma
from marie_tpu_torch.utils.device import resolve_device


class BoundaryNet(nn.Module):
    """[B, H, W, 3] float in [0, 1] -> [B, 8] corner coordinates in [0, 1]
    ((tl, tr, br, bl) x (x, y)), normalised to the input frame."""

    def __init__(self, cfg: BoundaryConfig):
        super().__init__()
        self.cfg = cfg
        c, cin = cfg.base_channels, 3
        for i in range(cfg.num_stages):
            cout = c * (2 ** min(i, 3))
            self.add_module(f"Conv_{i}", SameConv2d(cin, cout, 3, 2))
            self.add_module(f"GroupNorm_{i}", GroupNorm(cout))
            cin = cout
        self.Dense_0 = nn.Linear(cin, cfg.mlp_dim)
        self.Dense_1 = nn.Linear(cfg.mlp_dim, 8)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        h = images.permute(0, 3, 1, 2)
        for i in range(self.cfg.num_stages):
            h = getattr(self, f"Conv_{i}")(h)
            h = F.relu(getattr(self, f"GroupNorm_{i}")(h))
        h = h.mean(dim=(2, 3))  # global average pool
        h = F.relu(self.Dense_0(h))
        return torch.sigmoid(self.Dense_1(h))


def homography_from_points(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """H (3x3 float32, h22 = 1) with dst ~ H @ src from 4 correspondences
    (src, dst [4, 2] xy), solved on the host in float32."""
    src = np.asarray(src, np.float32)
    dst = np.asarray(dst, np.float32)
    x, y = src[:, 0], src[:, 1]
    xp, yp = dst[:, 0], dst[:, 1]
    zeros = np.zeros_like(x)
    ones = np.ones_like(x)
    rows_x = np.stack([x, y, ones, zeros, zeros, zeros, -x * xp, -y * xp], axis=-1)
    rows_y = np.stack([zeros, zeros, zeros, x, y, ones, -x * yp, -y * yp], axis=-1)
    a = np.concatenate([rows_x, rows_y], axis=0)  # [8, 8]
    b = np.concatenate([xp, yp], axis=0)  # [8]
    h = np.linalg.solve(a, b).astype(np.float32)
    return np.concatenate([h, np.ones((1,), np.float32)]).reshape(3, 3)


def _apply_homography(h: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor):
    """(x', y') [B, *S] of each H of ``h`` ([B, 3, 3] float32) applied to
    (xs, ys) [*S], each row ``h0 * x + h1 * y + h2`` rounded as XLA's CPU
    backend contracts it: ``fma(h0, x, h1 * y) + h2``."""
    h = h.reshape(-1, 3, 3, *([1] * xs.ndim))

    def row(r):
        return fma(h[:, r, 0], xs, h[:, r, 1] * ys) + h[:, r, 2]

    denom = row(2)
    denom = torch.where(torch.abs(denom) < 1e-8, torch.full_like(denom, 1e-8), denom)
    return row(0) / denom, row(1) / denom


def _pixel_grid(h: int, w: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    ys = torch.arange(h, dtype=torch.float32, device=device)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.float32, device=device)[None, :].expand(h, w)
    return xs, ys


def _page_rect(dh: int, dw: int) -> np.ndarray:
    """The corners (tl, tr, br, bl) of a dh x dw page, [4, 2] float32 xy."""
    return np.asarray([[0.0, 0.0], [dw - 1.0, 0.0], [dw - 1.0, dh - 1.0], [0.0, dh - 1.0]],
                      np.float32)


def warp_quad_to_page(image_u8, corners_px, out_h: int, out_w: int,
                      device="cuda") -> torch.Tensor:
    """Perspective-resample the quad ``corners_px`` ((tl, tr, br, bl) [4, 2]
    xy in image pixels) of ``image_u8`` [H, W, C] onto a full (out_h, out_w)
    page, the ``fit_to_page`` registration; samples from outside the image
    are white.  Returns uint8 [out_h, out_w, C] on ``device``."""
    dev = resolve_device(device)
    h_mat = torch.from_numpy(homography_from_points(_page_rect(out_h, out_w), corners_px))
    img = torch.as_tensor(image_u8).to(dev)
    sx, sy = (v[0] for v in _apply_homography(h_mat.to(dev), *_pixel_grid(out_h, out_w, dev)))
    out = _bilinear_hwc(img.to(torch.float32), sy, sx)
    ih, iw = img.shape[:2]
    oob = (sy < 0) | (sy > ih - 1) | (sx < 0) | (sx > iw - 1)
    out = torch.where(oob[..., None], torch.full_like(out, 255.0), out)
    return torch.clamp(out, 0, 255).to(torch.uint8)


def _composite(docs_u8: torch.Tensor, h: torch.Tensor, canvas_hw: Tuple[int, int],
               bg_gray: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """The per-pixel work of the scan composites: pages ``docs_u8`` [B, dh,
    dw, 3] uint8 sampled through ``h`` ([B, 3, 3] float32, canvas -> page
    coordinates) onto canvases whose backgrounds are ``bg_gray`` [B] +
    ``noise`` [B, H, W] (float32).  Returns uint8 [B, H, W, 3]."""
    ch, cw = canvas_hw
    b, dh, dw = docs_u8.shape[:3]
    dx, dy = _apply_homography(h, *_pixel_grid(ch, cw, docs_u8.device))  # [B, H, W]
    sampled = _bilinear_hwc(docs_u8.to(torch.float32), dy, dx)
    inside = (dx >= 0) & (dx <= dw - 1) & (dy >= 0) & (dy <= dh - 1)
    bg = torch.clamp(bg_gray[:, None, None] + noise, 0, 255)[..., None].expand(b, ch, cw, 3)
    out = torch.where(inside[..., None], sampled, bg)
    return torch.clamp(out, 0, 255).to(torch.uint8)


def composite_scan(doc_u8, corners_px, canvas_hw: Tuple[int, int], bg_gray: float,
                   noise, device="cuda") -> torch.Tensor:
    """Place a page ``doc_u8`` [dh, dw, 3] into the quad ``corners_px``
    ([4, 2] xy in canvas pixels) of a scanner canvas of ``canvas_hw``
    whose background is ``bg_gray + noise`` ([H, W] float).  Returns
    uint8 [H, W, 3] on ``device``."""
    dev = resolve_device(device)
    doc = torch.as_tensor(doc_u8).to(dev)
    h_inv = homography_from_points(corners_px, _page_rect(*doc.shape[:2]))  # canvas -> page
    noise = torch.as_tensor(noise, dtype=torch.float32).to(dev)
    bg = torch.tensor([np.float32(bg_gray)], dtype=torch.float32, device=dev)
    return _composite(doc[None], torch.from_numpy(h_inv).to(dev)[None], canvas_hw, bg,
                      noise[None])[0]


def homographies_from_points(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """[B, 3, 3] float32 (h22 = 1) with dst ~ H @ src from each page's 4
    correspondences (src, dst [B, 4, 2] xy): the rows of
    :func:`homography_from_points`, one batched solve on their device."""
    x, y = src[..., 0], src[..., 1]
    xp, yp = dst[..., 0], dst[..., 1]
    zeros = torch.zeros_like(x)
    ones = torch.ones_like(x)
    rows_x = torch.stack([x, y, ones, zeros, zeros, zeros, -x * xp, -y * xp], dim=-1)
    rows_y = torch.stack([zeros, zeros, zeros, x, y, ones, -x * yp, -y * yp], dim=-1)
    a = torch.cat([rows_x, rows_y], dim=1)  # [B, 8, 8]
    b = torch.cat([xp, yp], dim=1)  # [B, 8]
    # solve_ex: no host sync to check the factorisation, as a step needs none
    h = torch.linalg.solve_ex(a, b)[0]
    return torch.cat([h, ones[:, :1]], dim=1).reshape(-1, 3, 3)


def composite_scans(docs_u8: torch.Tensor, corners_px: torch.Tensor,
                    canvas_hw: Tuple[int, int], bg_gray: torch.Tensor,
                    noise: torch.Tensor) -> torch.Tensor:
    """:func:`composite_scan` of B pages at once on their device: pages
    ``docs_u8`` [B, dh, dw, 3] uint8 into quads ``corners_px`` [B, 4, 2]
    of canvases whose backgrounds are ``bg_gray`` [B] + ``noise`` [B, H,
    W].  One batched solve (:func:`homographies_from_points`), then the
    per-pixel work that :func:`composite_scan` runs on its host solve.
    Returns uint8 [B, H, W, 3]."""
    dev = docs_u8.device
    b, dh, dw = docs_u8.shape[:3]
    rect = torch.from_numpy(_page_rect(dh, dw)).to(dev).expand(b, 4, 2)
    h = homographies_from_points(corners_px.to(dev, torch.float32), rect)  # canvas -> page
    return _composite(docs_u8, h, canvas_hw, bg_gray.to(dev, torch.float32),
                      noise.to(dev, torch.float32))


def quad_iou(pred_px, true_px, hw: Tuple[int, int], device="cuda") -> torch.Tensor:
    """IoU of two convex quads ([4, 2] xy) by inside-tests on the pixel
    grid of ``hw``; a float32 scalar on ``device``."""
    dev = resolve_device(device)
    h, w = hw
    xs, ys = _pixel_grid(h, w, dev)

    def inside(quad):
        q = np.asarray(quad, np.float32)
        acc_pos = torch.ones((h, w), dtype=torch.bool, device=dev)
        acc_neg = torch.ones((h, w), dtype=torch.bool, device=dev)
        for i in range(4):
            ax, ay = q[i]
            bx, by = q[(i + 1) % 4]
            # the edge vector in float32, as the JAX version computes it
            cross = float(bx - ax) * (ys - float(ay)) - float(by - ay) * (xs - float(ax))
            acc_pos = acc_pos & (cross >= 0)
            acc_neg = acc_neg & (cross <= 0)
        return acc_pos | acc_neg

    a, b = inside(pred_px), inside(true_px)
    inter = (a & b).sum()
    union = (a | b).sum()
    return inter / torch.clamp(union, min=1)
