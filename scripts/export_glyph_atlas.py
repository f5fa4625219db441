"""Write ``torch_zoo/glyphs.npz``: the glyph atlas the port's text renderer
(``marie_tpu_torch/utils/glyphs.py``) draws with, in place of PIL's
FreeType fonts, which the card's machine does not have.

    python scripts/export_glyph_atlas.py          # ~1 min; needs Pillow with raqm
    python scripts/export_glyph_atlas.py --check  # also renders strings both ways

It holds, for the five DejaVu faces the trainers draw with (DejaVuSans,
-Bold, SansMono, SansMono-Bold, Serif; DejaVuSerif-Bold is the
recognizer's held-out face and stays out) at the pixel sizes 12-30 they
use, what Pillow's ``ImageDraw.text`` / ``textbbox`` / ``textlength`` read
from FreeType and raqm for printable ASCII:

* each glyph's rendered coverage cut to its ink, with its place from the
  pen (``getmask2`` of the glyph alone), plain and, at the recognizer's
  sizes, stroked by 1 and 2 pixels (``stroke_filled``, as ``draw.text``
  strokes);
* each glyph's advance in 26.6 fixed point (``getlength * 64``), the
  pair adjustments raqm's kerning adds to it, and the glyph's control box
  in pixels (``FT_Glyph_Get_CBox``, through the FreeType that Pillow
  links; the box Pillow's ``textbbox`` unions);
* the ligatures raqm substitutes (DejaVu's ``liga`` lookups read from the
  font's GSUB table: ff, fi, fl, ffi, ffl in the Sans and Serif faces,
  none in the Mono ones), as tokens of their own with their lookups'
  order;
* the ascender, the Pillow, FreeType and raqm versions, and the DejaVu
  licence line.

Every number is taken from Pillow and FreeType here; ``--check`` renders
random strings with PIL and with the atlas and reports how many agree.
"""

import argparse
import ctypes
import glob
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

FONT_DIR = "/usr/share/fonts/truetype/dejavu"
FACES = ("DejaVuSans", "DejaVuSans-Bold", "DejaVuSansMono", "DejaVuSansMono-Bold",
         "DejaVuSerif")
SIZES = (7, 9, 11, 12, 13, 14, 16, 18, 20, 22, 24, 26, 28, 30)
STROKE_SIZES = (14, 18, 20, 24, 30)  # the recognizer's sizes: its bold draws stroke 1 or 2
STROKES = (1, 2)
CHARS = tuple(chr(c) for c in range(32, 127))
OUT = os.path.join(REPO, "torch_zoo", "glyphs.npz")

FT_GLYPH_BBOX_PIXELS = 3
#: offset of ``glyph`` in FreeType's ``FT_FaceRec`` on a 64-bit build
FT_FACE_GLYPH_OFFSET = 152


class _BBox(ctypes.Structure):
    _fields_ = [("xMin", ctypes.c_long), ("yMin", ctypes.c_long),
                ("xMax", ctypes.c_long), ("yMax", ctypes.c_long)]


class FreeTypeBoxes:
    """Control boxes in pixels of a face's glyphs at a pixel size, through
    the FreeType library Pillow loaded (same version, same hinting: glyphs
    loaded with ``FT_LOAD_DEFAULT``, as Pillow's bounding box does)."""

    def __init__(self):
        from PIL import ImageFont

        ImageFont.truetype(os.path.join(FONT_DIR, "DejaVuSans.ttf"), 10)  # loads Pillow's FreeType
        import PIL

        libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs")
        self.lib = ctypes.CDLL(glob.glob(os.path.join(libs, "libfreetype-*.so*"))[0])
        self.handle = ctypes.c_void_p()
        if self.lib.FT_Init_FreeType(ctypes.byref(self.handle)):
            raise RuntimeError("FT_Init_FreeType failed")
        major, minor, patch = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        self.lib.FT_Library_Version(self.handle, ctypes.byref(major), ctypes.byref(minor),
                                    ctypes.byref(patch))
        self.version = f"{major.value}.{minor.value}.{patch.value}"

    def boxes(self, path: str, size: int, glyph_names):
        """{name: (xmin, ymin, xmax, ymax)} for glyphs named by character
        (a 1-char string) or by PostScript name (``uniFB01``, ``fi``)."""
        face = ctypes.c_void_p()
        if self.lib.FT_New_Face(self.handle, path.encode(), 0, ctypes.byref(face)):
            raise RuntimeError(f"cannot open {path}")
        self.lib.FT_Set_Pixel_Sizes(face, 0, size)
        out = {}
        try:
            for key, name in glyph_names.items():
                if len(name) == 1:
                    idx = self.lib.FT_Get_Char_Index(face, ord(name))
                else:
                    idx = self.lib.FT_Get_Name_Index(face, name.encode())
                if not idx and name != "\0":
                    raise RuntimeError(f"{path} has no glyph {name!r}")
                if self.lib.FT_Load_Glyph(face, idx, 0):
                    raise RuntimeError(f"FT_Load_Glyph failed for {name!r}")
                slot = ctypes.c_void_p.from_address(face.value + FT_FACE_GLYPH_OFFSET).value
                glyph = ctypes.c_void_p()
                if self.lib.FT_Get_Glyph(ctypes.c_void_p(slot), ctypes.byref(glyph)):
                    raise RuntimeError(f"FT_Get_Glyph failed for {name!r}")
                box = _BBox()
                self.lib.FT_Glyph_Get_CBox(glyph, FT_GLYPH_BBOX_PIXELS, ctypes.byref(box))
                self.lib.FT_Done_Glyph(glyph)
                out[key] = (box.xMin, box.yMin, box.xMax, box.yMax)
        finally:
            self.lib.FT_Done_Face(face)
        return out


def ligature_lookups(path: str):
    """The ``liga`` lookups of a face whose ligatures join printable ASCII:
    [(lookup index, [(ligature string, glyph name), ...] in the order a
    shaper tries them)], in lookup order."""
    from fontTools.ttLib import TTFont

    font = TTFont(path)
    gsub = font["GSUB"].table
    indices = sorted({i for rec in gsub.FeatureList.FeatureRecord
                      if rec.FeatureTag == "liga" for i in rec.Feature.LookupListIndex})
    cmap = {v: k for k, v in font.getBestCmap().items() if 32 <= k < 127}
    out = []
    for li in indices:
        entries = []
        for st in gsub.LookupList.Lookup[li].SubTable:
            st = getattr(st, "ExtSubTable", st)
            for first, ligs in getattr(st, "ligatures", {}).items():
                for lig in ligs:
                    parts = [first] + list(lig.Component)
                    if all(p in cmap for p in parts):
                        entries.append(("".join(chr(cmap[p]) for p in parts), lig.LigGlyph))
        if entries:
            out.append((li, entries))
    return out


def _glyph(font, text: str, stroke: int):
    """(ink bitmap, dx, dy) of ``text`` rendered alone at the pen (0, 0)
    with anchor ``la``: dx, dy place the bitmap's top-left from the pen's
    column and the ascender line's row."""
    mask, (ox, oy) = font.getmask2(text, "L", stroke_width=stroke, stroke_filled=True)
    w, h = mask.size
    arr = np.asarray(mask, np.uint8).reshape(h, w) if w * h else np.zeros((0, 0), np.uint8)
    ys, xs = np.nonzero(arr)
    if not len(ys):
        return np.zeros((0, 0), np.uint8), 0, 0
    return (arr[ys.min():ys.max() + 1, xs.min():xs.max() + 1], ox + int(xs.min()),
            oy + int(ys.min()))


def build():
    import PIL
    import PIL.features
    from PIL import ImageFont
    from fontTools.ttLib import TTFont

    from marie_tpu_torch.utils.glyphs import shape_tokens

    ft = FreeTypeBoxes()
    lookups = {face: ligature_lookups(os.path.join(FONT_DIR, f"{face}.ttf")) for face in FACES}
    ligs = sorted({s for face in FACES for _, ents in lookups[face] for s, _ in ents},
                  key=lambda s: (len(s), s))
    tokens = list(CHARS) + ligs
    tok_index = {t: i for i, t in enumerate(tokens)}
    n_tok = len(tokens)
    keys = [(f, s) for f in range(len(FACES)) for s in range(len(SIZES))]
    advance = np.full((len(keys), n_tok), -1, np.int32)
    cbox = np.zeros((len(keys), n_tok, 4), np.int16)
    ascender = np.zeros((len(keys),), np.int16)
    kern = []  # (key, a, b, value)
    bitmap_keys, pixels, offsets, hws, dxys = [], [], [], [], []
    n_pixels = 0
    for k, (fi, si) in enumerate(keys):
        face, size = FACES[fi], SIZES[si]
        path = os.path.join(FONT_DIR, f"{face}.ttf")
        font = ImageFont.truetype(path, size)
        face_lookups = [[s for s, _ in ents] for _, ents in lookups[face]]
        names = {t: t for t in CHARS}
        names.update({s: g for _, ents in lookups[face] for s, g in ents})
        for t, box in ft.boxes(path, size, names).items():
            cbox[k, tok_index[t]] = box
        ascender[k] = font.getmetrics()[0]
        # a ligature an earlier lookup always pre-empts (DejaVuSerif's ffi:
        # its ff lookup runs first) never reaches the page
        present = [t for t in tokens if t in names and shape_tokens(t, face_lookups) == [t]]
        for t in present:
            advance[k, tok_index[t]] = round(font.getlength(t) * 64)
            if font.getlength(t) * 64 != advance[k, tok_index[t]]:
                raise AssertionError("getlength is not in 1/64 px")
        for a in present:
            for b in present:
                if shape_tokens(a + b, face_lookups) != [a, b]:
                    continue  # the shaper never puts b after a
                v = (round(font.getlength(a + b) * 64) - advance[k, tok_index[a]]
                     - advance[k, tok_index[b]])
                if v:
                    kern.append((k, tok_index[a], tok_index[b], v))
        for stroke in (0,) + (STROKES if size in STROKE_SIZES else ()):
            bitmap_keys.append((fi, si, stroke))
            off = np.full((n_tok,), -1, np.int64)
            hw = np.zeros((n_tok, 2), np.int16)
            dxy = np.zeros((n_tok, 2), np.int16)
            for t in present:
                g, dx, dy = _glyph(font, t, stroke)
                i = tok_index[t]
                off[i], hw[i], dxy[i] = n_pixels, g.shape, (dx, dy)
                pixels.append(g.reshape(-1))
                n_pixels += g.size
            offsets.append(off)
            hws.append(hw)
            dxys.append(dxy)
        print(f"{face} {size}: {len(present)} glyphs", flush=True)
    licence = TTFont(os.path.join(FONT_DIR, "DejaVuSans.ttf"))["name"].getDebugName(13)
    meta = {
        "faces": list(FACES), "sizes": list(SIZES), "strokes": [0, *STROKES],
        "stroke_sizes": list(STROKE_SIZES), "tokens": tokens,
        "ligature_lookups": {face: [[s for s, _ in ents] for _, ents in lookups[face]]
                             for face in FACES},
        "pillow": PIL.__version__, "freetype": PIL.features.version("freetype2"),
        "freetype_ctypes": ft.version, "raqm": PIL.features.version("raqm"),
        "layout": "raqm" if PIL.features.check("raqm") else "basic",
        "licence": licence.splitlines()[0],
        "source": "scripts/export_glyph_atlas.py from /usr/share/fonts/truetype/dejavu",
    }
    if meta["freetype"] != ft.version:
        raise AssertionError(f"FreeType {ft.version} is not Pillow's {meta['freetype']}")
    kern = np.asarray(kern, np.int32).reshape(-1, 4)
    return dict(
        meta=np.asarray(json.dumps(meta, sort_keys=True)),
        advance=advance, cbox=cbox, ascender=ascender,
        kern_key=kern[:, 0].astype(np.int16), kern_a=kern[:, 1].astype(np.uint8),
        kern_b=kern[:, 2].astype(np.uint8), kern_value=kern[:, 3].astype(np.int16),
        bitmap_key=np.asarray(bitmap_keys, np.int16), glyph_offset=np.stack(offsets).astype(np.int32),
        glyph_hw=np.stack(hws), glyph_dxy=np.stack(dxys),
        pixels=np.concatenate(pixels).astype(np.uint8))


def check(n: int = 60, seed: int = 0):
    """Render ``n`` random strings per font both ways (plain and, where
    stored, stroked) and print the share equal to the bit."""
    from PIL import Image, ImageDraw, ImageFont

    from marie_tpu_torch.utils.glyphs import load_font

    rng = np.random.default_rng(seed)
    for face in FACES:
        for size in SIZES:
            pil = ImageFont.truetype(os.path.join(FONT_DIR, f"{face}.ttf"), size)
            mine = load_font(face, size)
            for stroke in (0,) + (STROKES if size in STROKE_SIZES else ()):
                equal = 0
                for _ in range(n):
                    text = "".join(rng.choice(list(CHARS), int(rng.integers(1, 15))))
                    x = 20 + (float(rng.integers(0, 64)) / 64 if rng.random() < 0.5 else 0)
                    img = Image.new("L", (40 * size, 3 * size), 255)
                    ImageDraw.Draw(img).text((x, 20), text, fill=0, font=pil, stroke_width=stroke)
                    canvas = np.full((3 * size, 40 * size), 255, np.uint8)
                    mine.draw_text(canvas, (x, 20), text, fill=0, stroke_width=stroke)
                    equal += bool(np.array_equal(canvas, np.asarray(img)))
                print(f"{face} {size} stroke {stroke}: {equal}/{n} equal", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args()
    arrays = build()
    np.savez_compressed(OUT, **arrays)
    print(json.dumps({"path": os.path.relpath(OUT, REPO), "bytes": os.path.getsize(OUT),
                      "raw_pixels": int(arrays["pixels"].size),
                      "kern_pairs": int(arrays["kern_key"].size)}), flush=True)
    if args.check:
        check()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
