"""Text rendering from a glyph atlas: the port's stand-in for PIL's
``ImageFont.truetype`` and ``ImageDraw.text`` (the card's machine has
neither PIL nor fonts).

``torch_zoo/glyphs.npz`` (``scripts/export_glyph_atlas.py``, made where
Pillow and the DejaVu fonts are) holds each printable ASCII glyph of the
faces and pixel sizes the trainers draw with: its coverage bitmap and
place from the pen, its 26.6 advance, the pair adjustments raqm's kerning
adds, its control box in pixels, and the ligatures raqm substitutes.  With
them this module lays text out and draws it as Pillow 12 does with raqm:

* **shaping**: the face's ``liga`` lookups, each over the whole string in
  turn, left to right, the first ligature of the lookup that matches at
  a position replacing it (:func:`shape_tokens`); then each glyph's pen
  is the sum of the advances and pair adjustments before it (26.6);
* **placement**: a glyph's bitmap lands at column ``int(x) +
  PIXEL(pen + frac(x) * 64) + dx`` and row ``int(y) + dy`` (PIXEL rounds
  26.6 to the nearest pixel, ``(v + 32) >> 6``), clipped to the mask
  Pillow allocates (the text's box, ``stroke_width`` wider on each side,
  one column more for a fractional ``x``);
* **the box** (``textbbox``): the union of the glyphs' control boxes at
  their rounded pens, the pen line from 0 to the rounded advance and the
  baseline, anchored at the ascender (Pillow's
  ``bounding_box_and_anchors``), widened by ``stroke_width``;
* **compositing**: the glyphs' coverages are merged in order as
  ``m + g - m * g / 255`` (Pillow's ``MULDIV255``), and the merged mask
  blends the fill over the canvas as ``(c * (255 - m) + fill * m) / 255``
  rounded (Pillow's ``BLEND``).  A stroked text is drawn once with the
  stroked glyphs (``stroke_filled``), as ``draw.text`` does when the
  stroke's fill is the text's.

A face, size or stroke the atlas lacks raises: there is no fallback to
another font.  Canvases are 2-D uint8 (one grey channel: most trainers draw
black on white, so the three channels of PIL's RGB canvas are equal) or
[H, W, 3] uint8 (the overlay trainer's coloured pages: Pillow blends each
channel alike).
"""

import json
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

ATLAS_NAME = "glyphs.npz"

_LOCK = threading.Lock()
_ATLAS: Dict[str, "GlyphAtlas"] = {}


def shape_tokens(text: str, lookups: Sequence[Sequence[str]]) -> List[str]:
    """``text`` as glyph tokens (characters, or ligature strings such as
    ``"fi"``) after the face's ligature ``lookups``: each lookup runs over
    the whole sequence left to right; at each position the first of its
    ligatures whose characters start there (as single-character tokens)
    replaces them."""
    toks = list(text)
    for lookup in lookups:
        out, i = [], 0
        while i < len(toks):
            for lig in lookup:
                n = len(lig)
                if toks[i] == lig[0] and "".join(toks[i:i + n]) == lig and all(
                        len(t) == 1 for t in toks[i:i + n]):
                    out.append(lig)
                    i += n
                    break
            else:
                out.append(toks[i])
                i += 1
        toks = out
    return toks


def _pixel(v: int) -> int:
    """26.6 to the nearest pixel, as FreeType's ``PIXEL`` in Pillow."""
    return (v + 32) >> 6


class GlyphAtlas:
    """The arrays of ``glyphs.npz``; :meth:`font` gives a face at a size."""

    def __init__(self, path: str):
        with np.load(path, allow_pickle=False) as data:
            arrays = {k: data[k] for k in data.files}
        self.path = path
        self.meta = json.loads(str(arrays.pop("meta")))
        self.arrays = arrays
        self.tokens: List[str] = self.meta["tokens"]
        self._fonts: Dict[Tuple[str, int], "GlyphFont"] = {}

    def font(self, face: str, size: int) -> "GlyphFont":
        faces, sizes = self.meta["faces"], self.meta["sizes"]
        if face not in faces:
            raise ValueError(f"the glyph atlas has no face {face!r} (it has {faces})")
        if size not in sizes:
            raise ValueError(f"the glyph atlas has no size {size} of {face} (it has {sizes})")
        key = (face, size)
        with _LOCK:
            if key not in self._fonts:
                self._fonts[key] = GlyphFont(self, faces.index(face), sizes.index(size))
            return self._fonts[key]


def load_atlas(path: Optional[str] = None) -> GlyphAtlas:
    """The atlas at ``path`` (default ``torch_zoo/glyphs.npz``), read once."""
    if path is None:
        from marie_tpu_torch.registry.zoo import ZOO_DIR

        path = os.path.join(ZOO_DIR, ATLAS_NAME)
    with _LOCK:
        if path not in _ATLAS:
            _ATLAS[path] = GlyphAtlas(path)
        return _ATLAS[path]


def load_font(face: str, size: int, path: Optional[str] = None) -> "GlyphFont":
    """A face (``"DejaVuSans"``, ``"DejaVuSerif"`` ...) at a pixel size:
    the counterpart of ``ImageFont.truetype(<face>.ttf, size)``."""
    return load_atlas(path).font(face, size)


class GlyphFont:
    """One face at one pixel size of the atlas (``ImageFont.FreeTypeFont``'s
    counterpart): ``size``, :meth:`getlength` / :meth:`textlength`,
    :meth:`getbbox`, :meth:`textbbox` and :meth:`draw_text`."""

    def __init__(self, atlas: GlyphAtlas, face_index: int, size_index: int):
        meta, a = atlas.meta, atlas.arrays
        self.face = meta["faces"][face_index]
        self.size = int(meta["sizes"][size_index])
        key = face_index * len(meta["sizes"]) + size_index
        self._tok = {t: i for i, t in enumerate(atlas.tokens)}
        self._lookups = meta["ligature_lookups"][self.face]
        self._adv = a["advance"][key]
        self._cbox = a["cbox"][key].astype(np.int64)
        self.ascender = int(a["ascender"][key])
        sel = a["kern_key"] == key
        self._kern = {(int(x), int(y)): int(v) for x, y, v in zip(
            a["kern_a"][sel], a["kern_b"][sel], a["kern_value"][sel])}
        self._glyphs: Dict[int, List[Tuple[np.ndarray, int, int]]] = {}
        pixels = a["pixels"]
        for b, (fi, si, stroke) in enumerate(a["bitmap_key"]):
            if fi != face_index or si != size_index:
                continue
            glyphs = []
            for i in range(len(atlas.tokens)):
                off = int(a["glyph_offset"][b, i])
                h, w = (int(v) for v in a["glyph_hw"][b, i])
                dx, dy = (int(v) for v in a["glyph_dxy"][b, i])
                bitmap = pixels[off:off + h * w].reshape(h, w) if off >= 0 else None
                glyphs.append((bitmap, dx, dy))
            self._glyphs[int(stroke)] = glyphs

    def __repr__(self) -> str:
        return f"GlyphFont({self.face!r}, {self.size})"

    # -- layout -----------------------------------------------------------
    def _layout(self, text: str) -> Tuple[List[int], List[int], int]:
        """(token indices, pens in 26.6, total advance in 26.6)."""
        idx = []
        for t in shape_tokens(text, self._lookups):
            i = self._tok.get(t)
            if i is None or self._adv[i] < 0:
                raise ValueError(f"{self!r} has no glyph for {t!r}")
            idx.append(i)
        pens, pen = [], 0
        for j, i in enumerate(idx):
            pens.append(pen)
            pen += int(self._adv[i])
            if j + 1 < len(idx):
                pen += self._kern.get((i, idx[j + 1]), 0)
        return idx, pens, pen

    def has_glyph(self, ch: str) -> bool:
        """Whether the atlas holds a glyph of the character ``ch``."""
        i = self._tok.get(ch)
        return i is not None and self._adv[i] >= 0

    def getlength(self, text: str) -> float:
        """The advance of ``text`` in pixels (a multiple of 1/64), as
        ``FreeTypeFont.getlength``."""
        return self._layout(text)[2] / 64.0

    textlength = getlength

    def _box(self, idx, pens) -> Tuple[int, int, int, int]:
        """Pillow's text box: (width, height, x offset, y offset) of the
        glyphs' control boxes and the pen line, anchored ``la``."""
        x_min = x_max = y_min = y_max = 0
        for i, pen in zip(idx, pens):
            px = _pixel(pen)
            x_max = max(x_max, _pixel(pen + int(self._adv[i])))
            b = self._cbox[i]
            x_min, x_max = min(x_min, b[0] + px), max(x_max, b[2] + px)
            y_min, y_max = min(y_min, b[1]), max(y_max, b[3])
        return x_max - x_min, y_max - y_min, x_min, self.ascender - y_max

    def getbbox(self, text: str, stroke_width: int = 0) -> Tuple[int, int, int, int]:
        """(left, top, right, bottom) of ``text`` drawn at (0, 0), as
        ``FreeTypeFont.getbbox``."""
        idx, pens, _ = self._layout(text)
        w, h, ox, oy = self._box(idx, pens)
        s = stroke_width
        return ox - s, oy - s, ox - s + w + 2 * s, oy - s + h + 2 * s

    def textbbox(self, xy, text: str, stroke_width: int = 0):
        """``ImageDraw.textbbox(xy, text, font, stroke_width=...)``."""
        l, t, r, b = self.getbbox(text, stroke_width)
        return l + xy[0], t + xy[1], r + xy[0], b + xy[1]

    # -- drawing ----------------------------------------------------------
    def mask(self, text: str, xy=(0, 0), stroke_width: int = 0):
        """(mask, (column, row)): Pillow's ``getmask2`` coverage of ``text``
        drawn at ``xy`` and where its top-left lands."""
        if stroke_width not in self._glyphs:
            raise ValueError(f"the glyph atlas has no stroke {stroke_width} bitmaps of {self!r} "
                             f"(it has {sorted(self._glyphs)})")
        glyphs = self._glyphs[stroke_width]
        idx, pens, _ = self._layout(text)
        w, h, ox, oy = self._box(idx, pens)
        s = stroke_width
        x, y = xy
        ix, iy = int(x), int(y)
        fx, fy = x - ix, y - iy
        mw = w + 2 * s + int(np.ceil(fx))
        mh = h + 2 * s + int(np.ceil(fy))
        col0, row0 = ix + ox - s, iy + oy - s
        m = np.zeros((max(mh, 0), max(mw, 0)), np.int32)
        shift = int(round(fx * 64))
        for i, pen in zip(idx, pens):
            g, dx, dy = glyphs[i]
            if g is None or g.size == 0:
                continue
            c = ix + _pixel(pen + shift) + dx - col0
            r = iy + dy - row0
            gh, gw = g.shape
            c0, r0 = max(c, 0), max(r, 0)
            c1, r1 = min(c + gw, mw), min(r + gh, mh)
            if c1 <= c0 or r1 <= r0:
                continue
            src = g[r0 - r:r1 - r, c0 - c:c1 - c].astype(np.int32)
            dst = m[r0:r1, c0:c1]
            t = dst * src + 128
            m[r0:r1, c0:c1] = dst + src - (((t >> 8) + t) >> 8)
        return m.astype(np.uint8), (col0, row0)

    def draw_text(self, canvas: np.ndarray, xy, text: str, fill=0,
                  stroke_width: int = 0) -> np.ndarray:
        """``ImageDraw.Draw(canvas).text(xy, text, fill=fill, font=self,
        stroke_width=stroke_width, stroke_fill=fill)`` into the uint8
        ``canvas``, in place; returns it.  A 2-D canvas is a grey image; an
        [H, W, 3] one an RGB image, each channel blended with its ink
        (``fill`` a value a channel, or Pillow's packed colour)."""
        from marie_tpu_torch.utils.pil_ops import _ink

        ink = _ink(canvas, fill)
        m, (col0, row0) = self.mask(text, xy, stroke_width)
        _blend(canvas, m, col0, row0, ink)
        return canvas


def _blend(canvas: np.ndarray, m: np.ndarray, col0: int, row0: int, ink) -> None:
    """Pillow's ``draw_bitmap``: ``ink`` blended over ``canvas`` ([H, W],
    or [H, W, C] with one ink a channel, each channel blended alike)
    through the coverage ``m`` placed at (col0, row0), clipped to the
    canvas."""
    H, W = canvas.shape[:2]
    mh, mw = m.shape
    c0, r0 = max(col0, 0), max(row0, 0)
    c1, r1 = min(col0 + mw, W), min(row0 + mh, H)
    if c1 <= c0 or r1 <= r0:
        return
    a = m[r0 - row0:r1 - row0, c0 - col0:c1 - col0].astype(np.int32)
    ink = np.asarray(ink, np.int32)
    if canvas.ndim == 3:
        a = a[..., None]
    out = canvas[r0:r1, c0:c1].astype(np.int32)
    t = out * (255 - a) + ink * a + 128
    canvas[r0:r1, c0:c1] = (((t >> 8) + t) >> 8).astype(np.uint8)
