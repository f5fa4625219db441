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

The drawing primitives draw in place on a uint8 ``[H, W]`` or ``[H, W, 3]``
canvas (``fill`` an int, or one value a channel), clipped to it, as
``ImageDraw.Draw`` draws opaque ink:

* :func:`draw_line`: ``line([(x0, y0), (x1, y1)], fill, width)`` of a
  horizontal or vertical segment (or a point).  Width 1 is Pillow's
  ``hline`` / vertical run, both ends included; a wider one is its
  ``ImagingDrawWideLine`` polygon, which across the segment covers
  ``ROUND_DOWN((width - 1) / 2)`` pixels before it and ``ROUND_UP((width -
  1) / 2)`` after (rows y and y+1 at width 2, y-1 to y+1 at width 3).  A
  slanted segment raises: Pillow fills its polygon edge by edge, which
  this module does not copy.
* :func:`draw_rectangle`: ``rectangle([x0, y0, x1, y1], fill, outline,
  width)``: the fill's rows ``y0..y1`` and columns ``x0..x1``; the outline
  ``width`` bands inset from each side, both corners included (on a box
  under ``2 * width`` across, the bands as Pillow's loop overlaps them).
* :func:`draw_ellipse`: ``ellipse([x0, y0, x1, y1], fill, outline,
  width)``: Pillow's integer ellipse (``ellipse_new`` in ``Draw.c``, since
  Pillow 8), two concentric quarter curves walked in half-pixel steps by
  Bresenham's rule, their rows joined into horizontal spans.
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


# --- drawing --------------------------------------------------------------


def _ink(canvas: np.ndarray, fill):
    """The ink ``ImageDraw`` makes of ``fill`` for the canvas: on a 2-D
    canvas a number clipped to 0..255; on a 3-D one a value a channel, or
    a number read as Pillow's packed colour (channel c is byte c)."""
    if canvas.dtype != np.uint8 or canvas.ndim not in (2, 3):
        raise ValueError("a canvas is uint8 [H, W] or [H, W, C]")
    if canvas.ndim == 2:
        v = int(np.asarray(fill).reshape(-1)[0])
        return np.uint8(min(max(v, 0), 255))
    channels = canvas.shape[2]
    if np.ndim(fill) == 0:
        v = int(fill)
        return np.array([(v >> (8 * c)) & 255 for c in range(channels)], np.uint8)
    ink = np.asarray(fill, np.int64).reshape(-1)
    if ink.size != channels:
        raise ValueError(f"fill {fill!r} for a canvas of {channels} channels")
    return ink.astype(np.uint8)


def _span(canvas: np.ndarray, ink, y0: int, y1: int, x0: int, x1: int) -> None:
    """Rows y0..y1 and columns x0..x1 (both ends included) set to ``ink``,
    clipped to the canvas."""
    h, w = canvas.shape[:2]
    y0, x0 = max(y0, 0), max(x0, 0)
    y1, x1 = min(y1, h - 1), min(x1, w - 1)
    if y0 <= y1 and x0 <= x1:
        canvas[y0:y1 + 1, x0:x1 + 1] = ink


def _round_up(f: float) -> int:
    """Pillow's ``ROUND_UP``: halves away from zero."""
    return int(math.floor(f + 0.5)) if f >= 0.0 else -int(math.floor(abs(f) + 0.5))


def _round_down(f: float) -> int:
    """Pillow's ``ROUND_DOWN``: halves toward zero."""
    return int(math.ceil(f - 0.5)) if f >= 0.0 else -int(math.ceil(abs(f) - 0.5))


def draw_line(canvas: np.ndarray, xy, fill, width: int = 1) -> np.ndarray:
    """``ImageDraw.Draw(img).line(xy, fill=fill, width=width)`` of one
    horizontal or vertical segment ``xy = [(x0, y0), (x1, y1)]`` (integer
    points) on ``canvas``, in place; returns it."""
    ink = _ink(canvas, fill)
    (x0, y0), (x1, y1) = ((int(x), int(y)) for x, y in xy)
    if x0 != x1 and y0 != y1:
        raise ValueError("draw_line draws horizontal and vertical segments only")
    if width <= 1 or (x0, y0) == (x1, y1):
        # ImagingDrawLine (a point where the segment is one)
        _span(canvas, ink, min(y0, y1), max(y0, y1), min(x0, x1), max(x0, x1))
        return canvas
    half = (width - 1) / 2.0
    before, after = _round_down(half), _round_up(half)
    # the wide line's polygon: across the segment, ``before`` pixels on the
    # side its direction turns from and ``after`` on the other
    if y0 == y1:
        lo, hi = (-before, after) if x1 > x0 else (-after, before)
        _span(canvas, ink, y0 + lo, y0 + hi, min(x0, x1), max(x0, x1))
    else:
        lo, hi = (-before, after) if y1 > y0 else (-after, before)
        _span(canvas, ink, min(y0, y1), max(y0, y1), x0 + lo, x0 + hi)
    return canvas


def _outline(canvas: np.ndarray, fill, outline):
    """The outline's ink as ``ImageDraw._getink`` gives it: the draw's
    default ink (-1: white on an RGB canvas, 0 on a grey one) where
    neither ink is given; none where it is the fill's ink."""
    if outline is None and fill is None:
        return _ink(canvas, -1)
    if outline is None:
        return None
    ink = _ink(canvas, outline)
    if fill is not None and np.array_equal(ink, _ink(canvas, fill)):
        return None
    return ink


def _box(xy):
    x0, y0, x1, y1 = (int(v) for v in (xy if len(xy) == 4 else (*xy[0], *xy[1])))
    if x1 < x0:
        raise ValueError("x1 must be greater than or equal to x0")
    if y1 < y0:
        raise ValueError("y1 must be greater than or equal to y0")
    return x0, y0, x1, y1


def draw_rectangle(canvas: np.ndarray, xy, fill=None, outline=None,
                   width: int = 1) -> np.ndarray:
    """``ImageDraw.Draw(img).rectangle(xy, fill=fill, outline=outline,
    width=width)`` on ``canvas``, in place (the fill first, then the
    outline where it is another colour; the default ink where neither is
    given);
    returns it."""
    x0, y0, x1, y1 = _box(xy)
    if fill is not None:
        _span(canvas, _ink(canvas, fill), y0, y1, x0, x1)
    ink = _outline(canvas, fill, outline)
    if ink is not None and width != 0:
        t = max(int(width), 1)
        # the sides are Pillow's ``line`` primitive from y0 + t towards
        # y1 - t + 1, that end left out (past each other on a box under 2t
        # high, where the run goes back up)
        ya, yb = y0 + t, y1 - t + 1
        rows = (ya, yb - 1) if ya <= yb else (yb + 1, ya)
        for i in range(t):
            _span(canvas, ink, y0 + i, y0 + i, x0, x1)
            _span(canvas, ink, y1 - i, y1 - i, x0, x1)
            _span(canvas, ink, rows[0], rows[1], x1 - i, x1 - i)
            _span(canvas, ink, rows[0], rows[1], x0 + i, x0 + i)
    return canvas


class _Quarter:
    """Pillow's ``quarter_state``: a quarter of the ellipse with semi-axes
    a/2 and b/2, walked in doubled coordinates from (a, b % 2) to
    (a % 2, b), each step to whichever of (x, y + 2), (x - 2, y + 2) and
    (x - 2, y) lies nearest the curve ``a^2 y^2 + b^2 x^2 = a^2 b^2``."""

    def __init__(self, a: int, b: int):
        self.finished = a < 0 or b < 0
        if self.finished:
            return
        self.cx, self.cy, self.ex, self.ey = a, b % 2, a % 2, b
        self.a2, self.b2 = a * a, b * b
        self.a2b2 = self.a2 * self.b2

    def _delta(self, x: int, y: int) -> int:
        return abs(self.a2 * y * y + self.b2 * x * x - self.a2b2)

    def next(self):
        if self.finished:
            return None
        point = (self.cx, self.cy)
        if self.cx == self.ex and self.cy == self.ey:
            self.finished = True
        else:
            nx, ny = self.cx, self.cy + 2
            nd = self._delta(nx, ny)
            if nx > 1:
                d = self._delta(self.cx - 2, self.cy + 2)
                if nd > d:
                    nx, ny, nd = self.cx - 2, self.cy + 2, d
                d = self._delta(self.cx - 2, self.cy)
                if nd > d:
                    nx, ny = self.cx - 2, self.cy
            self.cx, self.cy = nx, ny
        return point


def _ellipse_spans(a: int, b: int, w: int):
    """Pillow's ``ellipse_init`` / ``ellipse_next``: the (left, y, right)
    spans, in doubled coordinates about the centre, of the ring between
    the outer quarter (a, b) and the inner one (a - 2(w - 1), b - 2(w -
    1)), mirrored into the four quadrants."""
    outer = _Quarter(a, b)
    leftmost = a % 2
    first = outer.next()
    if w < 1 or first is None:
        return
    pr, py = first
    inner = _Quarter(a - 2 * (w - 1), b - 2 * (w - 1))
    pl = leftmost
    finished = False
    while not finished:
        y, l, r = py, pl, pr
        while True:
            p = outer.next()
            if p is None or p[1] > y:
                break
        if p is None:
            finished = True
        else:
            pr, py = p
        while True:
            q = inner.next()
            if q is None or q[1] > y:
                break
            l = q[0]
        pl = leftmost if q is None else q[0]
        spans = []
        if (l > 0 or l < r) and y > 0:
            spans.append((2 if l == 0 else l, y, r))
        if y > 0:
            spans.append((-r, y, -l))
        if l > 0 or l < r:
            spans.append((2 if l == 0 else l, -y, r))
        spans.append((-r, -y, -l))
        yield from reversed(spans)


def draw_ellipse(canvas: np.ndarray, xy, fill=None, outline=None,
                 width: int = 1) -> np.ndarray:
    """``ImageDraw.Draw(img).ellipse(xy, fill=fill, outline=outline,
    width=width)`` on ``canvas``, in place (the fill first, then the
    outline where it is another colour; the default ink where neither is
    given);
    returns it."""
    x0, y0, x1, y1 = _box(xy)
    a, b = x1 - x0, y1 - y0

    def draw(ink, w):
        for l, y, r in _ellipse_spans(a, b, w):
            row = y0 + (y + b) // 2
            _span(canvas, ink, row, row, x0 + (l + a) // 2, x0 + (r + a) // 2)

    if fill is not None:
        draw(_ink(canvas, fill), a + b)
    ink = _outline(canvas, fill, outline)
    if ink is not None and width != 0:
        draw(ink, int(width))
    return canvas
