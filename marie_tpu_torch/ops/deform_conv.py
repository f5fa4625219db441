"""Deformable convolution v1 and v2 (port of
``marie_tpu/ops/deform_conv.py``): each output position samples the input
at its kernel taps moved by learned offsets (bilinear, zero outside the
map), v2 weighs each sample by a mask, and the samples laid out as
im2col columns go through one matrix product with the weights (a
library product, in full float32, as in the JAX version, which computes
it outside any Pallas kernel).
"""

from typing import Optional

import torch

from marie_tpu_torch.utils.device import float32_precision, resolve_device


def _bilinear_sample(feat: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """``feat`` [N, C, H, W]; ``ys``/``xs`` [N, ...] -> [N, C, ...]: the
    JAX gather's arithmetic (the taps' indices clipped to the map, the
    weights from the unclipped coordinate; 0 where the sample is at or
    past one pixel outside)."""
    n, c, h, w = feat.shape
    oob = (ys <= -1.0) | (ys >= h) | (xs <= -1.0) | (xs >= w)
    y0, x0 = torch.floor(ys), torch.floor(xs)
    ly, lx = ys - y0, xs - x0
    y0i = y0.to(torch.int64).clamp(0, h - 1)
    x0i = x0.to(torch.int64).clamp(0, w - 1)
    y1i = (y0i + 1).clamp(0, h - 1)
    x1i = (x0i + 1).clamp(0, w - 1)
    flat = feat.reshape(n, c, h * w)
    shape = ys.shape

    def take(yi, xi):
        idx = (yi * w + xi).reshape(n, 1, -1).expand(n, c, -1)
        return torch.gather(flat, 2, idx).reshape((n, c) + shape[1:])

    hy, hx = 1.0 - ly, 1.0 - lx

    def wt(a, b):
        return (a * b)[:, None]

    val = (take(y0i, x0i) * wt(hy, hx) + take(y0i, x1i) * wt(hy, lx)
           + take(y1i, x0i) * wt(ly, hx) + take(y1i, x1i) * wt(ly, lx))
    return torch.where(oob[:, None], torch.zeros((), dtype=val.dtype, device=val.device), val)


def deform_conv2d(
    x: torch.Tensor,
    offsets: torch.Tensor,
    weight: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    stride: int = 1,
    padding: int = 1,
    dilation: int = 1,
    *,
    device="cuda",
) -> torch.Tensor:
    """Deformable convolution on ``device`` (v2 with ``mask``, else v1).

    x [N, C_in, H, W]; offsets [N, 2*Kh*Kw, H_out, W_out], (dy, dx) for
    each tap in turn (the torchvision / detectron2 layout); weight
    [C_out, C_in, Kh, Kw]; mask [N, Kh*Kw, H_out, W_out]; bias [C_out].
    Returns [N, C_out, H_out, W_out] in x's dtype."""
    dev = resolve_device(device)
    x = torch.as_tensor(x).to(dev)
    offsets = torch.as_tensor(offsets).to(dev)
    weight = torch.as_tensor(weight).to(dev)
    n, c_in, h, w = x.shape
    c_out, _, kh, kw = weight.shape
    h_out = (h + 2 * padding - dilation * (kh - 1) - 1) // stride + 1
    w_out = (w + 2 * padding - dilation * (kw - 1) - 1) // stride + 1
    taps = kh * kw
    oy = torch.arange(h_out, device=dev) * stride - padding
    ox = torch.arange(w_out, device=dev) * stride - padding
    ky = torch.arange(kh, device=dev) * dilation
    kx = torch.arange(kw, device=dev) * dilation
    by = (ky[:, None, None, None] + oy[None, None, :, None]).expand(kh, kw, h_out, w_out)
    bx = (kx[None, :, None, None] + ox[None, None, None, :]).expand(kh, kw, h_out, w_out)
    off = offsets.reshape(n, taps, 2, h_out, w_out)
    ys = by.reshape(taps, h_out, w_out).to(off.dtype)[None] + off[:, :, 0]
    xs = bx.reshape(taps, h_out, w_out).to(off.dtype)[None] + off[:, :, 1]
    cols = _bilinear_sample(x, ys, xs)  # [N, C_in, K, H_out, W_out]
    if mask is not None:
        cols = cols * torch.as_tensor(mask).to(dev)[:, None]
    with float32_precision(False):  # a full float32 product, whatever TF32 says
        out = torch.matmul(weight.reshape(c_out, c_in * taps),
                           cols.reshape(n, c_in * taps, h_out * w_out))
    out = out.reshape(n, c_out, h_out, w_out)
    if bias is not None:
        out = out + torch.as_tensor(bias).to(dev)[None, :, None, None]
    return out.to(x.dtype)
