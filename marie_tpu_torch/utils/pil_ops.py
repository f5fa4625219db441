"""The PIL image operations the synthetic-data renderers use, in numpy on
the host (the card's machine has no PIL): each gives the bytes Pillow 12
gives on a 2-D uint8 image (an RGB image whose three channels are equal is
the same image three times).

* :func:`resize_bilinear`: ``Image.resize(size, BILINEAR)``, Pillow's
  ``ImagingResample``: separable, horizontal pass first (on the rows the
  vertical pass reads), the triangle filter's support widened by the
  scale when it shrinks, weights normalised in double and rounded to
  22-bit fixed point, each pass rounded and clipped to uint8.  This is not
  ``preprocess/resize.py::resize_linear_u8`` (cv2's ``INTER_LINEAR``).
* :func:`transform_affine`: ``Image.transform(size, AFFINE, data,
  BILINEAR, fillcolor=fill)``: each output pixel centre mapped through
  the matrix in double, bilinear from the clamped 2x2 neighbours, the
  result truncated to uint8; a source point outside the image leaves
  ``fill``.
* :func:`rotate`: ``Image.rotate(angle, BILINEAR, center=, fillcolor=)``:
  Pillow's matrix (cosines rounded to 15 places) through
  :func:`transform_affine`.
* :func:`crop`: ``Image.crop(box)``, zeros outside the image.
* :func:`to_gray`: ``Image.convert("L")`` of an RGB array (ITU-R 601-2 in
  Pillow's 16-bit fixed point).
"""

import functools
import math
from typing import Sequence, Tuple

import numpy as np

PRECISION_BITS = 32 - 8 - 2


@functools.lru_cache(maxsize=4096)
def _coeffs(in_size: int, out_size: int):
    """Pillow's ``precompute_coeffs`` for the bilinear filter over the whole
    axis, then ``normalize_coeffs_8bpc``: (first tap [out], tap count [out],
    fixed-point weights [out, k], zero past each output's taps); every
    step in double as Pillow computes it, the weights summed one by one."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    center = (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    xmins = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    counts = np.minimum(np.trunc(center + support + 0.5), in_size).astype(np.int64) - xmins
    taps = np.arange(ksize)[None, :]
    w = 1.0 - np.abs((taps + xmins[:, None] - center[:, None] + 0.5) * ss)
    w = np.where((w > 0.0) & (taps < counts[:, None]), w, 0.0)
    total = np.zeros(out_size)
    for j in range(ksize):  # adding the zeros past the taps changes nothing
        total = total + w[:, j]
    w = np.where(total[:, None] != 0.0, w / np.where(total != 0.0, total, 1.0)[:, None], w)
    kk = (0.5 + w * (1 << PRECISION_BITS)).astype(np.int64)  # (int) truncates
    return xmins, counts, np.where(taps < counts[:, None], kk, 0)


def _resample(img: np.ndarray, xmins: np.ndarray, kk: np.ndarray, axis: int) -> np.ndarray:
    """One pass: each output the fixed-point sum of its taps along ``axis``
    (0: rows, 1: columns), rounded and clipped to uint8."""
    idx = np.minimum(xmins[:, None] + np.arange(kk.shape[1])[None, :], img.shape[axis] - 1)
    src = img.astype(np.int64)
    if axis == 1:
        acc = (src[:, idx] * kk[None]).sum(axis=-1)
    else:
        acc = (src[idx] * kk[:, :, None]).sum(axis=1)
    acc = acc + (1 << (PRECISION_BITS - 1))
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bilinear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``Image.fromarray(img).resize(size, Image.BILINEAR)`` of a 2-D uint8
    image; ``size`` is (width, height) as PIL takes it."""
    w, h = int(size[0]), int(size[1])
    ih, iw = img.shape
    if (w, h) == (iw, ih):
        return img.copy()
    ymins, ycounts, ky = _coeffs(ih, h)
    out = img
    if w != iw:
        # the horizontal pass runs on the rows the vertical pass reads
        y0, y1 = int(ymins[0]), int(ymins[-1] + ycounts[-1])
        xmins, _, kx = _coeffs(iw, w)
        out = _resample(img[y0:y1], xmins, kx, axis=1)
        ymins = ymins - y0
    if h != ih:
        out = _resample(out, ymins, ky, axis=0)
    return out


def transform_affine(img: np.ndarray, size: Tuple[int, int], data: Sequence[float],
                     fill: int = 255) -> np.ndarray:
    """``Image.fromarray(img).transform(size, Image.AFFINE, data,
    resample=Image.BILINEAR, fillcolor=fill)`` of a 2-D uint8 image.

    Only the output pixels whose source taps can reach a pixel other than
    ``fill`` are computed: the rest are ``fill`` either way (bilinear of
    four equal values is that value, and a point outside leaves
    ``fill``)."""
    a, b, c, d, e, f = (float(v) for v in data[:6])
    w, h = int(size[0]), int(size[1])
    ih, iw = img.shape
    out = np.full((h, w), fill, np.uint8)
    ys, xs = np.nonzero(img != fill)
    if not len(ys):
        return out
    # the source box of the pixels other than fill, two pixels wider, back
    # through the inverse map to an output box (an affine map sends the
    # box's corners to a parallelogram that holds its image)
    det = a * e - b * d
    corners = np.array([[xs.min() - 2.0, ys.min() - 2.0], [xs.max() + 3.0, ys.min() - 2.0],
                        [xs.min() - 2.0, ys.max() + 3.0], [xs.max() + 3.0, ys.max() + 3.0]])
    u, v = corners[:, 0] - c, corners[:, 1] - f
    ox = (e * u - b * v) / det
    oy = (-d * u + a * v) / det
    x0 = max(int(np.floor(ox.min())) - 2, 0)
    x1 = min(int(np.ceil(ox.max())) + 3, w)
    y0 = max(int(np.floor(oy.min())) - 2, 0)
    y1 = min(int(np.ceil(oy.max())) + 3, h)
    if x1 <= x0 or y1 <= y0:
        return out
    xs_ = np.arange(x0, x1, dtype=np.float64)[None, :] + 0.5
    ys_ = np.arange(y0, y1, dtype=np.float64)[:, None] + 0.5
    xin = a * xs_ + b * ys_ + c
    yin = d * xs_ + e * ys_ + f
    inside = (xin >= 0.0) & (xin < iw) & (yin >= 0.0) & (yin < ih)
    xin = xin - 0.5
    yin = yin - 0.5
    x = np.floor(xin).astype(np.int64)
    y = np.floor(yin).astype(np.int64)
    dx = xin - x
    dy = yin - y
    src = img.astype(np.float64)
    xa = np.clip(x, 0, iw - 1)
    xb = np.clip(x + 1, 0, iw - 1)
    ya = np.clip(y, 0, ih - 1)
    has_yb = (y + 1 >= 0) & (y + 1 < ih)
    yb = np.clip(y + 1, 0, ih - 1)
    top = src[ya, xa] + (src[ya, xb] - src[ya, xa]) * dx
    bot = src[yb, xa] + (src[yb, xb] - src[yb, xa]) * dx
    bot = np.where(has_yb, bot, top)
    val = top + (bot - top) * dy
    region = out[y0:y1, x0:x1]
    region[inside] = val[inside].astype(np.uint8)  # C's (UINT8) cast truncates
    return out


def rotation_matrix(angle: float, center: Tuple[float, float]):
    """``Image.rotate``'s affine matrix (no translate, no expand)."""
    rad = -math.radians(angle % 360.0)
    m = [round(math.cos(rad), 15), round(math.sin(rad), 15), 0.0,
         round(-math.sin(rad), 15), round(math.cos(rad), 15), 0.0]
    cx, cy = center
    m[2] = m[0] * -cx + m[1] * -cy + m[2]
    m[5] = m[3] * -cx + m[4] * -cy + m[5]
    m[2] += cx
    m[5] += cy
    return m


def rotate(img: np.ndarray, angle: float, center: Tuple[float, float],
           fill: int = 255) -> np.ndarray:
    """``Image.fromarray(img).rotate(angle, resample=Image.BILINEAR,
    center=center, fillcolor=fill)`` of a 2-D uint8 image."""
    h, w = img.shape
    return transform_affine(img, (w, h), rotation_matrix(angle, center), fill)


def crop(img: np.ndarray, box: Tuple[int, int, int, int]) -> np.ndarray:
    """``Image.crop(box)``: ``box`` is (left, top, right, bottom); what lies
    outside the image is 0, as PIL leaves it."""
    l, t, r, b = (int(v) for v in box)
    h, w = img.shape
    out = np.zeros((max(b - t, 0), max(r - l, 0)), img.dtype)
    sl, st, sr, sb = max(l, 0), max(t, 0), min(r, w), min(b, h)
    if sr > sl and sb > st:
        out[st - t:sb - t, sl - l:sr - l] = img[st:sb, sl:sr]
    return out


def to_gray(rgb: np.ndarray) -> np.ndarray:
    """``Image.convert("L")`` of an [H, W, 3] uint8 array."""
    x = rgb.astype(np.uint32)
    return ((x[..., 0] * 19595 + x[..., 1] * 38470 + x[..., 2] * 7471 + 0x8000)
            >> 16).astype(np.uint8)
