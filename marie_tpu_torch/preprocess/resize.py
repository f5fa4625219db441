"""Host image resizes and the grayscale conversion that give cv2's bits,
in numpy (the card has no cv2).

The JAX package resizes with cv2 in two places: an oversize page is
downscaled to the largest bucket with ``INTER_AREA``
(``marie_tpu/boxes/craft_box_processor.py:292-297``), and a host fragment
is resized to the recogniser's height with ``INTER_LINEAR``
(``marie_tpu/document/trocr_ocr_processor.py:223-225``,
``marie_tpu/document/crnn_ocr_processor.py:143``), after
``COLOR_RGB2GRAY`` for the CRNN (:func:`rgb2gray_u8`).  The resizes here
take uint8 ``[H, W]`` or ``[H, W, C]`` images and a target size
``(width, height)`` as cv2 does, and follow cv2's arithmetic for uint8:

* :func:`resize_linear_u8`: fixed-point bilinear.  Each tap weight is the
  float32 weight times 2^11 rounded to a short (``INTER_RESIZE_COEF_BITS``);
  a row is the integer sum of its two taps, and the two rows combine as
  ``((b0 * (r0 >> 4)) >> 16) + ((b1 * (r1 >> 4)) >> 16) + 2) >> 2``.  A
  source column past an edge takes the edge pixel at full weight; a row
  past an edge keeps its weights and reads the edge row.  Halving both
  sides exactly is cv2's 2x2 area average.
* :func:`resize_area_u8`: a downscale by an integer factor on both sides
  averages whole cells (2x2: ``(sum + 2) >> 2``; others: the sum times the
  float32 reciprocal of the cell area, rounded half to even); any other
  downscale weighs each source pixel by its float32 share of the target
  cell, summed in float32 in cv2's order, rounded half to even.  Growing
  either side is cv2's area-mode bilinear, which the port never asks for
  and which is refused here.
* :func:`rgb2gray_u8`: ``(9798 R + 19235 G + 3735 B + 2^14) >> 15``, the
  15-bit fixed point of cv2's vectorised uint8 path (cv2's 14-bit scalar
  coefficients give the same bytes only on some inputs).
"""

import math
from typing import Tuple

import numpy as np

_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS


def _check(img: np.ndarray, size: Tuple[int, int]) -> Tuple[int, int]:
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"resize takes uint8 [H, W] or [H, W, C], got {img.dtype} {img.shape}")
    dw, dh = int(size[0]), int(size[1])
    if dw <= 0 or dh <= 0 or img.shape[0] == 0 or img.shape[1] == 0:
        raise ValueError(f"empty resize {img.shape[:2]} -> ({dh}, {dw})")
    return dw, dh


def _round_half_even_u8(x: np.ndarray) -> np.ndarray:
    return np.clip(np.rint(x), 0, 255).astype(np.uint8)


def _integer_factor(src: int, dst: int) -> int:
    """cv2's test for an integer scale (``|scale - int(scale)| < DBL_EPSILON``);
    0 when the scale is not an integer."""
    scale = 1.0 / (dst / src)
    iscale = int(math.floor(scale + 0.5))
    return iscale if abs(scale - iscale) < np.finfo(np.float64).eps else 0


def _area_fast(img: np.ndarray, fx: int, fy: int) -> np.ndarray:
    """Whole-cell average for integer factors (the source is exactly
    ``fy * dh`` by ``fx * dw``)."""
    h, w = img.shape[:2]
    cells = img.reshape(h // fy, fy, w // fx, fx, *img.shape[2:]).astype(np.int32)
    total = cells.sum(axis=(1, 3))
    if fx == 2 and fy == 2:
        return ((total + 2) >> 2).astype(np.uint8)
    return _round_half_even_u8(total.astype(np.float32) * np.float32(1.0 / (fx * fy)))


def _area_taps(src: int, dst: int, scale: float):
    """cv2's ``computeResizeAreaTab`` as arrays: [dst, taps] source index
    and float32 weight (0 past each cell's last tap), in cv2's order."""
    rows = []
    for d in range(dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, src - f1)
        s2 = min(math.floor(f2), src - 1)
        s1 = min(math.ceil(f1), s2)
        taps = []
        if s1 - f1 > 1e-3:
            taps.append((s1 - 1, np.float32((s1 - f1) / cell)))
        taps.extend((s, np.float32(1.0 / cell)) for s in range(s1, s2))
        if f2 - s2 > 1e-3:
            taps.append((s2, np.float32(min(min(f2 - s2, 1.0), cell) / cell)))
        rows.append(taps)
    n = max(len(t) for t in rows)
    idx = np.zeros((dst, n), np.int64)
    wts = np.zeros((dst, n), np.float32)
    for d, taps in enumerate(rows):
        for k, (s, a) in enumerate(taps):
            idx[d, k], wts[d, k] = s, a
    return idx, wts


def resize_area_u8(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=cv2.INTER_AREA)`` for a
    downscale (``size`` = (width, height), each at most the image's)."""
    dw, dh = _check(img, size)
    h, w = img.shape[:2]
    if (dh, dw) == (h, w):
        return img.copy()
    if dw > w or dh > h:
        raise ValueError(f"resize_area_u8 downscales only: {img.shape[:2]} -> ({dh}, {dw})")
    fx, fy = _integer_factor(w, dw), _integer_factor(h, dh)
    if fx and fy:
        return _area_fast(img, fx, fy)
    xi, xa = _area_taps(w, dw, w / dw)
    yi, ya = _area_taps(h, dh, h / dh)
    # horizontal: buf[y, dx] accumulates S[y, si] * alpha over the taps in
    # order, in float32 (a zero-weight pad tap adds exactly 0)
    src = img.astype(np.float32)
    buf = np.zeros((h, dw) + img.shape[2:], np.float32)
    for k in range(xi.shape[1]):
        wk = xa[:, k].reshape((1, dw) + (1,) * (img.ndim - 2))
        buf = buf + src[:, xi[:, k]] * wk
    # vertical: sum = beta0 * buf[r0], then sum += beta_k * buf[r_k]
    out = None
    for k in range(yi.shape[1]):
        wk = ya[:, k].reshape((dh, 1) + (1,) * (img.ndim - 2))
        term = buf[yi[:, k]] * wk
        out = term if out is None else out + term
    return _round_half_even_u8(out)


def _linear_taps(src: int, dst: int, clamp_weights: bool):
    """Per target index: (i0, i1, w0, w1) with cv2's float32 weights
    rounded to 11-bit shorts.  Columns (``clamp_weights``) past an edge
    read the edge pixel at full weight; rows keep their weights."""
    scale = src / dst
    d = np.arange(dst, dtype=np.float64)
    f = ((d + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if clamp_weights:
        low, high = s < 0, s >= src - 1
        f = np.where(low | high, np.float32(0.0), f)
        s = np.where(low, 0, np.where(high, src - 1, s))
    w0 = np.rint((np.float32(1.0) - f) * np.float32(_COEF_SCALE)).astype(np.int64)
    w1 = np.rint(f * np.float32(_COEF_SCALE)).astype(np.int64)
    i0 = np.clip(s, 0, src - 1)
    i1 = np.clip(s + 1, 0, src - 1)
    return i0, i1, w0, w1


def resize_linear_u8(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)``
    (``size`` = (width, height))."""
    dw, dh = _check(img, size)
    h, w = img.shape[:2]
    if (dh, dw) == (h, w):
        return img.copy()
    if _integer_factor(w, dw) == 2 and _integer_factor(h, dh) == 2:
        return _area_fast(img, 2, 2)
    x0, x1, a0, a1 = _linear_taps(w, dw, True)
    y0, y1, b0, b1 = _linear_taps(h, dh, False)
    chan = (1,) * (img.ndim - 2)
    src = img.astype(np.int64)
    rows = (src[:, x0] * a0.reshape((1, dw) + chan)
            + src[:, x1] * a1.reshape((1, dw) + chan))  # [h, dw, ...]
    r0 = rows[y0] >> 4
    r1 = rows[y1] >> 4
    b0 = b0.reshape((dh, 1) + chan)
    b1 = b1.reshape((dh, 1) + chan)
    out = (((b0 * r0) >> 16) + ((b1 * r1) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def rgb2gray_u8(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)`` of a uint8 [H, W, 3|4]
    image (a fourth channel is ignored)."""
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[-1] not in (3, 4):
        raise ValueError(f"rgb2gray_u8 takes uint8 [H, W, 3|4], got {img.dtype} {img.shape}")
    x = img.astype(np.int32)
    gray = (x[..., 0] * 9798 + x[..., 1] * 19235 + x[..., 2] * 3735 + (1 << 14)) >> 15
    return gray.astype(np.uint8)
