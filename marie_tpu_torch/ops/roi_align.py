"""ROIAlign (port of ``marie_tpu/ops/roi_align.py``): every ROI's P x P bins
take S x S bilinear samples each (detectron2's ``aligned=True``
continuous coordinates), gathered from the feature map and averaged.

Samples outside ``[-1, H] x [-1, W]`` contribute 0; the others are
clipped to the map before ``floor`` picks their taps, so the clipped
coordinate feeds both the index and the weight.  The arithmetic is the
JAX version's as XLA's CPU backend rounds it: ``box * scale - offset`` and
``y0 + frac * (h / P)`` are fused multiply-adds, the divide by P is a
multiply by its float32 reciprocal, and the four-tap sum is a chain of
fused multiply-adds (:func:`~marie_tpu_torch.preprocess.ops.fma`).  That
makes :func:`roi_align_single` equal the JAX one to the bit; under
``vmap`` XLA fuses the batched JAX ``roi_align`` otherwise, and the two
agree to a few float32 ulps.

:func:`roi_align_rotated` samples each rotated ROI's grid about its
centre, turned by its angle, through the same gather.
"""

import torch

from marie_tpu_torch.ops.rotated_iou import cos_sin_degrees
from marie_tpu_torch.preprocess.ops import fma
from marie_tpu_torch.utils.device import resolve_device


def _bilinear_gather(flat: torch.Tensor, h: int, w: int, bidx: torch.Tensor,
                     ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """``flat`` [N, H*W, C] feature maps; ``bidx`` [K] the map of each row
    of ``ys``/``xs`` [K, ...] -> [K, ..., C]."""
    oob = (ys < -1.0) | (ys > h) | (xs < -1.0) | (xs > w)
    ys = torch.clamp(ys, 0.0, h - 1.0)
    xs = torch.clamp(xs, 0.0, w - 1.0)
    y0 = torch.floor(ys).to(torch.int64)
    x0 = torch.floor(xs).to(torch.int64)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    ly = ys - y0.to(ys.dtype)
    lx = xs - x0.to(xs.dtype)
    hy, hx = 1.0 - ly, 1.0 - lx
    k = ys.shape[0]
    b = bidx.to(torch.int64).view(k, *([1] * (ys.ndim - 1)))

    def take(yi, xi):
        return flat[b, yi * w + xi]  # [K, ..., C]

    def wt(a, c):
        return (a * c)[..., None]

    acc = take(y0, x0) * wt(hy, hx)
    acc = fma(take(y0, x1), wt(hy, lx), acc)
    acc = fma(take(y1, x0), wt(ly, hx), acc)
    acc = fma(take(y1, x1), wt(ly, lx), acc)
    return torch.where(oob[..., None], 0.0, acc)


def _roi_align(features: torch.Tensor, bidx: torch.Tensor, boxes: torch.Tensor,
               output_size: int, spatial_scale: float, sampling_ratio: int,
               aligned: bool) -> torch.Tensor:
    """[N, C, H, W] maps, [K] map of each box, [K, 4] xyxy -> [K, C, P, P]."""
    p, s = output_size, max(sampling_ratio, 1)
    n, c, h, w = features.shape
    dev = features.device
    boxes = boxes.to(torch.float32)
    k = boxes.shape[0]
    scale = torch.tensor(spatial_scale, dtype=torch.float32, device=dev)
    offset = torch.tensor(-0.5 if aligned else 0.0, dtype=torch.float32, device=dev)
    x0, y0, x1, y1 = (fma(boxes[:, i], scale, offset) for i in range(4))
    rw, rh = x1 - x0, y1 - y0
    if not aligned:
        rw = torch.clamp(rw, min=1.0)
        rh = torch.clamp(rh, min=1.0)
    inv_p = torch.tensor(1.0 / p, dtype=torch.float32, device=dev)
    bins = torch.arange(p, dtype=torch.float32, device=dev)
    samples = (torch.arange(s, dtype=torch.float32, device=dev) + 0.5) * torch.tensor(
        1.0 / s, dtype=torch.float32, device=dev)
    frac = (bins[:, None] + samples[None, :]).reshape(-1)  # [P*S]
    ys = fma(frac[None], (rh * inv_p)[:, None], y0[:, None])  # [K, P*S]
    xs = fma(frac[None], (rw * inv_p)[:, None], x0[:, None])
    grid_y = ys[:, :, None].expand(k, p * s, p * s)
    grid_x = xs[:, None, :].expand(k, p * s, p * s)
    flat = features.to(torch.float32).reshape(n, c, h * w).transpose(1, 2)
    vals = _bilinear_gather(flat, h, w, bidx, grid_y, grid_x)  # [K, PS, PS, C]
    vals = vals.reshape(k, p, s, p, s, c)
    total = vals[:, :, 0, :, 0]
    for i in range(s):
        for j in range(s):
            if i or j:
                total = total + vals[:, :, i, :, j]
    return (total * (1.0 / (s * s))).permute(0, 3, 1, 2)


def roi_align_single(
    feat: torch.Tensor,
    boxes: torch.Tensor,
    output_size: int = 7,
    spatial_scale: float = 1.0,
    sampling_ratio: int = 2,
    aligned: bool = True,
    *,
    device="cuda",
) -> torch.Tensor:
    """ROIAlign over one feature map [C, H, W] for boxes [K, 4] (xyxy in
    the map's coordinates before ``spatial_scale``) -> [K, C, P, P], on
    ``device`` (the card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    feat = torch.as_tensor(feat).to(dev)
    boxes = torch.as_tensor(boxes).to(dev)
    bidx = torch.zeros(boxes.shape[0], dtype=torch.int64, device=dev)
    return _roi_align(feat[None], bidx, boxes, output_size, spatial_scale,
                      sampling_ratio, aligned)


def roi_align(
    features: torch.Tensor,
    rois: torch.Tensor,
    output_size: int = 7,
    spatial_scale: float = 1.0,
    sampling_ratio: int = 2,
    aligned: bool = True,
    *,
    device="cuda",
) -> torch.Tensor:
    """ROIAlign over maps [N, C, H, W] for rois [K, 5] (batch index, x0,
    y0, x1, y1 in input coordinates) -> [K, C, P, P]: P x P bins of S x S
    samples each, averaged; on ``device``."""
    dev = resolve_device(device)
    features = torch.as_tensor(features).to(dev)
    rois = torch.as_tensor(rois).to(dev)
    return _roi_align(features, rois[:, 0].to(torch.int32), rois[:, 1:], output_size,
                      spatial_scale, sampling_ratio, aligned)


def _recip(n: int, dev) -> torch.Tensor:
    return torch.tensor(1.0 / n, dtype=torch.float32, device=dev)


def roi_align_rotated(
    features: torch.Tensor,
    rois: torch.Tensor,
    output_size: int = 7,
    spatial_scale: float = 1.0,
    sampling_ratio: int = 2,
    *,
    device="cuda",
) -> torch.Tensor:
    """ROIAlignRotated over maps [N, C, H, W] for rois [K, 6] (batch
    index, cx, cy, w, h, angle in degrees counter-clockwise, in input
    coordinates) -> [K, C, P, P]: the P x P bins of S x S samples of the
    box's own frame, turned by its angle about its centre (half-pixel
    aligned), averaged; on ``device``."""
    dev = resolve_device(device)
    features = torch.as_tensor(features).to(dev)
    rois = torch.as_tensor(rois, dtype=torch.float32).to(dev)
    p, s = output_size, max(sampling_ratio, 1)
    n, c, h, w = features.shape
    k = rois.shape[0]
    cx = rois[:, 1] * spatial_scale - 0.5
    cy = rois[:, 2] * spatial_scale - 0.5
    rw = rois[:, 3] * spatial_scale
    rh = rois[:, 4] * spatial_scale
    cos_t, sin_t = cos_sin_degrees(rois[:, 5])
    cos_t, sin_t = cos_t[:, None, None], sin_t[:, None, None]
    # divisions by P and S as products with their float32 reciprocals (as
    # XLA and torch's CUDA division by a scalar compute them; the CPU's
    # would divide)
    bins = torch.arange(p, dtype=torch.float32, device=dev)
    samples = (torch.arange(s, dtype=torch.float32, device=dev) + 0.5) * _recip(s, dev)
    frac = ((bins[:, None] + samples[None, :]) * _recip(p, dev)).reshape(-1)  # [P*S]
    off_y = ((frac[None] - 0.5) * rh[:, None])[:, :, None]  # [K, P*S, 1]
    off_x = ((frac[None] - 0.5) * rw[:, None])[:, None, :]  # [K, 1, P*S]
    xs = cx[:, None, None] + off_x * cos_t - off_y * sin_t  # [K, P*S, P*S]
    ys = cy[:, None, None] + off_x * sin_t + off_y * cos_t
    flat = features.to(torch.float32).reshape(n, c, h * w).transpose(1, 2)
    vals = _bilinear_gather(flat, h, w, rois[:, 0].to(torch.int64), ys, xs)
    vals = vals.reshape(k, p, s, p, s, c)
    return vals.mean(dim=(2, 4)).permute(0, 3, 1, 2)
