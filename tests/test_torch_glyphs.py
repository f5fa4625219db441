"""The glyph atlas renderer (``marie_tpu_torch/utils/glyphs.py``) and the
numpy PIL operations (``utils/pil_ops.py``) against Pillow, and the
gzipped zoo JSON files.

For every face and size of ``torch_zoo/glyphs.npz``, 200 strings of the
recognizer's open-vocabulary generator are drawn by PIL and by the atlas,
plain and with each stored stroke: ``getlength`` within 1/64 px,
``textbbox`` equal, at least 99.9% of the pixels equal and the ink box
within 1 px (the atlas was measured equal to the bit on every string of
the export's check).  ``pil_ops``: ``resize`` BILINEAR equal to the bit up
and down, ``transform`` AFFINE and ``rotate`` within one grey level.
"""

import gzip
import hashlib
import os

import numpy as np
import pytest
from PIL import Image, ImageDraw, ImageFont

from marie_tpu_torch.registry.zoo import ZOO_DIR, open_zoo_json, zoo_json_path
from marie_tpu_torch.utils import pil_ops
from marie_tpu_torch.utils.glyphs import load_atlas, load_font

FONT_DIR = "/usr/share/fonts/truetype/dejavu"
ATLAS = load_atlas()
FONTS = [(f, s) for f in ATLAS.meta["faces"] for s in ATLAS.meta["sizes"]]
STRINGS = 200
PIXEL_SHARE = 0.999


def _strings(n: int, seed: int):
    from marie_tpu_torch.models.configs import TrOCRConfig
    from marie_tpu_torch.train.recognizer import SyntheticWordDataset

    ds = SyntheticWordDataset(TrOCRConfig.tiny(), seed=seed, font_sizes=(12,), text_mode="open")
    return [ds._random_text_open() for _ in range(n)]


def _ink(a):
    ys, xs = np.nonzero(a < 255)
    return (xs.min(), ys.min(), xs.max(), ys.max()) if len(ys) else None


@pytest.mark.parametrize("face,size", FONTS)
def test_atlas_draws_as_pil(face, size):
    pil = ImageFont.truetype(os.path.join(FONT_DIR, f"{face}.ttf"), size)
    mine = load_font(face, size)
    strokes = [s for s in ATLAS.meta["strokes"]
               if s == 0 or size in ATLAS.meta["stroke_sizes"]]
    rng = np.random.default_rng(size)
    h, w = 3 * size + 20, 16 * size + 60
    for stroke in strokes:
        equal = total = bit_equal = 0
        for i, text in enumerate(_strings(STRINGS, FONTS.index((face, size)))):
            assert abs(mine.getlength(text) - pil.getlength(text)) <= 1 / 64, text
            # the bold path draws at fractional pens (multiples of 1/64)
            x = 12 + (int(rng.integers(0, 64)) / 64 if i % 2 else 0)
            img = Image.new("L", (w, h), 255)
            draw = ImageDraw.Draw(img)
            draw.text((x, 10), text, fill=0, font=pil, stroke_width=stroke)
            want = np.asarray(img)
            assert mine.textbbox((12, 10), text, stroke_width=stroke) == draw.textbbox(
                (12, 10), text, font=pil, stroke_width=stroke), text
            got = mine.draw_text(np.full((h, w), 255, np.uint8), (x, 10), text, fill=0,
                                 stroke_width=stroke)
            equal += int((got == want).sum())
            total += got.size
            bit_equal += bool(np.array_equal(got, want))
            a, b = _ink(got), _ink(want)
            assert (a is None) == (b is None), text
            if a is not None:
                assert max(abs(u - v) for u, v in zip(a, b)) <= 1, text
        assert equal / total >= PIXEL_SHARE, (stroke, equal / total, bit_equal)
        print(f"{face} {size} stroke {stroke}: {equal / total:.6f} of pixels, "
              f"{bit_equal}/{STRINGS} strings equal")


def test_atlas_contents_and_refusals():
    meta = ATLAS.meta
    assert meta["faces"] == ["DejaVuSans", "DejaVuSans-Bold", "DejaVuSansMono",
                             "DejaVuSansMono-Bold", "DejaVuSerif"]
    assert "DejaVuSerif-Bold" not in meta["faces"]  # the recognizer's held-out face
    assert meta["sizes"] == [7, 9, 11, 12, 13, 14, 16, 18, 20, 22, 24, 26, 28, 30]
    assert meta["stroke_sizes"] == [14, 18, 20, 24, 30] and meta["strokes"] == [0, 1, 2]
    assert meta["pillow"] and meta["freetype"] and meta["raqm"] and meta["layout"] == "raqm"
    assert "DejaVu changes are in public domain" in meta["licence"]
    # the ligatures raqm substitutes, and none in the Mono faces
    assert meta["ligature_lookups"]["DejaVuSansMono"] == []
    sans = load_font("DejaVuSans", 24)
    assert sans.getlength("fi") == ImageFont.truetype(
        os.path.join(FONT_DIR, "DejaVuSans.ttf"), 24).getlength("fi")
    with pytest.raises(ValueError, match="no face"):
        load_font("DejaVuSerif-Bold", 24)
    with pytest.raises(ValueError, match="no size"):
        load_font("DejaVuSans", 15)
    with pytest.raises(ValueError, match="no stroke 1"):
        load_font("DejaVuSans", 12).draw_text(np.full((40, 80), 255, np.uint8), (0, 0), "a",
                                              stroke_width=1)
    with pytest.raises(ValueError, match="no glyph"):
        sans.getlength("é")


@pytest.mark.parametrize("src,dst", [((40, 300), (320, 48)), ((57, 410), (320, 48)),
                                     ((30, 120), (70, 18)), ((48, 200), (110, 25)),
                                     ((13, 21), (64, 40)), ((512, 384), (230, 307))])
def test_resize_bilinear_equals_pil(src, dst):
    rng = np.random.default_rng(src[0] * dst[0])
    img = rng.integers(0, 256, src).astype(np.uint8)
    img[:, : src[1] // 3] = 255  # white runs as the crops have
    want = np.asarray(Image.fromarray(img).resize(dst, Image.BILINEAR))
    got = pil_ops.resize_bilinear(img, dst)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pil_ops.resize_bilinear(img, src[::-1]), img)


@pytest.mark.parametrize("kind", ["shear", "rotate"])
def test_affine_and_rotate_within_one_grey_level(kind):
    rng = np.random.default_rng(7)
    worst = 0
    for _ in range(40):
        h, w = (int(v) for v in rng.integers(20, 90, 2))
        img = np.full((h, w), 255, np.uint8)
        img[h // 4: 3 * h // 4, w // 5: 4 * w // 5] = rng.integers(0, 256, (
            3 * h // 4 - h // 4, 4 * w // 5 - w // 5))
        if kind == "shear":
            sh = float(rng.uniform(-0.25, 0.25))
            data = (1, sh, -sh * 20, 0, 1, 0)
            want = np.asarray(Image.fromarray(img).transform(
                (w, h), Image.AFFINE, data, resample=Image.BILINEAR, fillcolor=255))
            got = pil_ops.transform_affine(img, (w, h), data, 255)
        else:
            angle, c = float(rng.uniform(-2, 2)), (float(rng.uniform(0, w)), float(rng.uniform(0, h)))
            want = np.asarray(Image.fromarray(img).rotate(angle, resample=Image.BILINEAR, center=c,
                                                          fillcolor=255))
            got = pil_ops.rotate(img, angle, c, 255)
        worst = max(worst, int(np.abs(got.astype(int) - want).max()))
    assert worst <= 1


def test_crop_and_gray_equal_pil():
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (10, 12)).astype(np.uint8)
    for box in [(-3, -2, 5, 7), (4, 4, 20, 15), (0, 0, 12, 10)]:
        np.testing.assert_array_equal(pil_ops.crop(img, box),
                                      np.asarray(Image.fromarray(img).crop(box)))
    rgb = rng.integers(0, 256, (7, 9, 3)).astype(np.uint8)
    np.testing.assert_array_equal(pil_ops.to_gray(rgb), np.asarray(Image.fromarray(rgb).convert("L")))


#: sha256 of each zoo JSON file's bytes before it was gzipped
ZOO_JSON_SHA256 = {
    "golden": "cf3f06ba23302b49565bfe575749d21db8e12a63e1188dae7f27ec2aba26e8bb",
    "golden_best": "f443736839dd7469b7d1e6c121794ca6b3117ba660ef42811727be3861c4f18b",
    "golden_classify": "65fc3c12c969f206f7035b660393b5d315787b1d5862293aea81ca92a6cee351",
    "golden_detectors": "24ee89ac40219cb6f6589548f5daa4f685e7f5605fbdc438c0836b9dfffe1f88",
    "golden_extract": "1e95e91857ec290be207653d182ff53014f72034d0d9740e92d5dad1b8141be9",
    "golden_reading_order": "8375705ed3eb8fc26a2fd2dd81cf407d42debdbfd363acf41230d7d150656fab",
    "golden_register": "f6a3b9b22831a1496b4fd7869cf0ca1cd1268f54a6e3b1e389198f15091894f2",
    "truth": "159a444f958369be7f83bef8cfb1fdf24d2a3b4b58f6176e38bdf6536d59a99b",
}


@pytest.mark.parametrize("name", sorted(ZOO_JSON_SHA256) + ["golden_train"])
def test_zoo_json_is_gzipped_losslessly(name):
    path = zoo_json_path(name)
    assert not os.path.exists(os.path.join(ZOO_DIR, f"{name}.json"))
    with open(path, "rb") as f:
        head = f.read(10)
    assert head[:3] == b"\x1f\x8b\x08" and head[4:8] == b"\0\0\0\0"  # deflate, no time stamp
    with gzip.open(path, "rb") as f:
        raw = f.read()
    if name in ZOO_JSON_SHA256:
        assert hashlib.sha256(raw).hexdigest() == ZOO_JSON_SHA256[name]
    with open_zoo_json(name) as f:
        assert f.read() == raw.decode("utf-8")
