"""The port's image files (``marie_tpu_torch/utils/image_io.py``) against
PIL, which the JAX package writes them with, on the CPU: PNG and
multi-page TIFF written by the port read by PIL as the same pixels, and
PIL's files (adaptive PNG filters, PackBits TIFF) read by the port as
the same pixels; the port's JPEG decoded by PIL at a PSNR no more than
0.5 dB under PIL's own quality-80 encode of the same image, at a size
within 15% of PIL's (measured: the same bytes as PIL's, on every image
tried, since the encoder follows libjpeg's integer DCT, quantisation and
edge handling; ``test_jpeg_on_shipped_pages`` pins that on the shipped
pages).
"""

import io

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image, ImageSequence

from marie_tpu_torch.utils import image_io

PSNR_SLACK_DB = 0.5
SIZE_SLACK = 0.15

shapes = st.tuples(st.integers(1, 67), st.integers(1, 67))
layouts = st.sampled_from(["gray", "rgb"])


def _image(seed, hw, layout, kind="smooth"):
    rng = np.random.default_rng(seed)
    shape = hw if layout == "gray" else hw + (3,)
    if kind == "noise":
        return rng.integers(0, 256, shape, dtype=np.uint8)
    # a text-like page: white with dark strokes and a gray band
    img = np.full(shape, 255, np.uint8)
    h, w = hw
    for _ in range(max(1, h * w // 200)):
        y, x = rng.integers(0, h), rng.integers(0, w)
        img[y:y + rng.integers(1, 4), x:x + rng.integers(1, 9)] = rng.integers(0, 90)
    img[h // 3:h // 3 + max(1, h // 8)] = np.minimum(img[h // 3:h // 3 + max(1, h // 8)], 200)
    return img


def _pil_frames(data):
    return [np.asarray(f.copy()) for f in ImageSequence.Iterator(Image.open(io.BytesIO(data)))]


@settings(max_examples=40, deadline=None)
@given(hw=shapes, layout=layouts, seed=st.integers(0, 2**16), kind=st.sampled_from(
    ["smooth", "noise"]))
def test_png_round_trips_with_pil(hw, layout, seed, kind):
    img = _image(seed, hw, layout, kind)
    buf = io.BytesIO()
    image_io.write_png(buf, img)
    assert np.array_equal(np.asarray(Image.open(io.BytesIO(buf.getvalue()))), img)
    # PIL's own PNG (adaptive filters on 8-bit images) read by the port
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    assert np.array_equal(image_io.read_png(io.BytesIO(buf.getvalue())), img)


def _png_with_filters(img, filters):
    """A PNG whose row y is stored with filter ``filters[y % len]`` (PIL
    picks its filters adaptively and takes no choice), encoded here in
    plain numpy as the PNG specification defines them."""
    import struct
    import zlib

    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(h, w * c).astype(np.int64)
    prev = np.zeros(w * c, np.int64)
    out = []
    for y in range(h):
        cur, filt = rows[y], filters[y % len(filters)]
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), prev[:-c]])
        p = left + prev - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        pred = [0, left, prev, (left + prev) // 2, paeth][filt]
        out.append(bytes([filt]) + ((cur - pred) % 256).astype(np.uint8).tobytes())
        prev = cur
    color = {1: 0, 3: 2, 4: 6}[c]
    return (b"\x89PNG\r\n\x1a\n"
            + image_io._chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + image_io._chunk(b"IDAT", zlib.compress(b"".join(out)))
            + image_io._chunk(b"IEND", b""))


@pytest.mark.parametrize("filters", [[0], [1], [2], [3], [4], [3, 4, 1, 0, 2]])
@pytest.mark.parametrize("layout", ["gray", "rgb"])
def test_png_reader_takes_every_filter_type(filters, layout):
    """Each of the five scanline filters, and all five mixed row by row,
    read by the port as PIL reads them."""
    img = _image(len(filters) + filters[0], (23, 31), layout, "noise")
    data = _png_with_filters(img, filters)
    assert np.array_equal(np.asarray(Image.open(io.BytesIO(data))), img)
    assert np.array_equal(image_io.read_png(io.BytesIO(data)), img)


@settings(max_examples=30, deadline=None)
@given(hw=shapes, layout=layouts, seed=st.integers(0, 2**16), pages=st.integers(1, 3),
       compression=st.sampled_from(["packbits", "raw"]))
def test_tiff_round_trips_with_pil(hw, layout, seed, pages, compression):
    frames = [_image(seed + k, hw, layout, "noise" if k % 2 else "smooth") for k in range(pages)]
    buf = io.BytesIO()
    image_io.write_tiff(buf, frames, compression)
    got = _pil_frames(buf.getvalue())
    assert len(got) == pages
    for g, f in zip(got, frames):
        assert np.array_equal(g, f)
    assert all(np.array_equal(g, f)
               for g, f in zip(image_io.read_tiff(io.BytesIO(buf.getvalue())), frames))
    # PIL's multi-page PackBits TIFF (as the JAX package writes results.tif)
    buf = io.BytesIO()
    imgs = [Image.fromarray(f) for f in frames]
    imgs[0].save(buf, format="TIFF", save_all=True, append_images=imgs[1:],
                 compression="packbits")
    got = image_io.read_tiff(io.BytesIO(buf.getvalue()))
    assert len(got) == pages and all(np.array_equal(g, f) for g, f in zip(got, frames))


def test_tiff_bilevel_and_long_runs():
    """bool pages as 1-bit, and runs past PackBits' 128-byte packets."""
    rng = np.random.default_rng(5)
    mask = rng.random((19, 301)) > 0.3
    flat = np.full((7, 700), 255, np.uint8)
    flat[3, 100:400] = 0
    buf = io.BytesIO()
    image_io.write_tiff(buf, [mask, flat])
    got = _pil_frames(buf.getvalue())
    assert np.array_equal(got[0], mask) and np.array_equal(got[1], flat)
    port = image_io.read_tiff(io.BytesIO(buf.getvalue()))
    assert np.array_equal(port[0], mask * 255) and np.array_equal(port[1], flat)


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def _jpeg_against_pil(img):
    ours = image_io.encode_jpeg(img)
    rgb = img if img.ndim == 3 else np.stack([img] * 3, axis=-1)
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, format="JPEG", quality=80)
    theirs = buf.getvalue()
    decoded = np.asarray(Image.open(io.BytesIO(ours)).convert("RGB"))
    assert decoded.shape == rgb.shape
    pil_decoded = np.asarray(Image.open(io.BytesIO(theirs)).convert("RGB"))
    return _psnr(rgb, decoded), _psnr(rgb, pil_decoded), len(ours), len(theirs)


@settings(max_examples=40, deadline=None)
@given(hw=shapes, layout=layouts, seed=st.integers(0, 2**16), kind=st.sampled_from(
    ["smooth", "noise"]))
def test_jpeg_decodes_in_pil_as_well_as_pils_own(hw, layout, seed, kind):
    ours_db, pil_db, ours_n, pil_n = _jpeg_against_pil(_image(seed, hw, layout, kind))
    assert ours_db >= pil_db - PSNR_SLACK_DB
    assert abs(ours_n - pil_n) <= SIZE_SLACK * pil_n


@pytest.mark.parametrize("which", ["gray", "rgb", "gray_as_rgb"])
def test_jpeg_on_shipped_pages(which):
    """A 1024x768 shipped page (gray, and its RGB stack: the same bytes)
    and the RGB form, at full size."""
    import os

    from marie_tpu_torch.registry.zoo import ZOO_DIR

    with np.load(os.path.join(ZOO_DIR, "pages.npz")) as data:
        page, rgb = data["pages"][3], data["rgb"]
    img = {"gray": page, "rgb": rgb, "gray_as_rgb": np.stack([page] * 3, axis=-1)}[which]
    ours_db, pil_db, ours_n, pil_n = _jpeg_against_pil(img)
    assert ours_db >= pil_db - PSNR_SLACK_DB
    assert abs(ours_n - pil_n) <= SIZE_SLACK * pil_n
    if which == "gray_as_rgb":
        assert image_io.encode_jpeg(img) == image_io.encode_jpeg(page)
    # measured with this PIL: libjpeg-turbo's bytes
    buf = io.BytesIO()
    Image.fromarray(img if img.ndim == 3 else np.stack([img] * 3, axis=-1)).save(
        buf, format="JPEG", quality=80)
    assert image_io.encode_jpeg(img) == buf.getvalue()


def test_jpeg_headers_match_pils():
    """The quantisation and Huffman tables PIL writes at quality 80."""
    img = _image(1, (40, 56), "rgb", "noise")
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=80)

    def segments(data, marker):
        out, i = [], 2
        while data[i + 1] != 0xDA:
            n = int.from_bytes(data[i + 2:i + 4], "big")
            if data[i + 1] == marker:
                out.append(data[i + 4:i + 2 + n])
            i += 2 + n
        return out

    ours = image_io.encode_jpeg(img)
    for marker in (0xDB, 0xC4, 0xC0):
        assert segments(ours, marker) == segments(buf.getvalue(), marker)
    assert Image.open(io.BytesIO(ours)).layers == 3


def test_writers_refuse_what_they_do_not_take():
    with pytest.raises(ValueError):
        image_io.write_png(io.BytesIO(), np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError):
        image_io.write_png(io.BytesIO(), np.zeros((4, 4, 4), np.uint8))
    with pytest.raises(ValueError):
        image_io.write_tiff(io.BytesIO(), [np.zeros((4, 4, 2), np.uint8)])
    with pytest.raises(ValueError):
        image_io.encode_jpeg(np.zeros((4, 4, 4), np.uint8))
    with pytest.raises(ValueError):
        image_io.read_png(io.BytesIO(b"not a png"))
