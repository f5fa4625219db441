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

The readers added for template definitions and bilevel pages are held
to PIL to the bit: baseline JPEG (gray, 4:4:4 and 4:2:0, restart
markers, odd sizes, the shipped pages), BMP (8-bit palette, 24- and
32-bit, top-down, BI_BITFIELDS), CCITT G4 strips (the port's writer
gives PIL/libtiff's bytes and the reader reads them back), big-endian
and 1-bit TIFF, and PNG with alpha.
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



# --- readers held to PIL ------------------------------------------------------

def _pil_jpeg(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _pil_decoded(data):
    im = Image.open(io.BytesIO(data))
    return np.asarray(im.convert("L" if im.mode == "L" else "RGB"))


@pytest.mark.parametrize("hw", [(17, 23), (1, 1), (2, 3), (16, 16), (33, 9), (64, 47)])
@pytest.mark.parametrize("layout,subsampling", [("gray", None), ("rgb", 0), ("rgb", 2)])
def test_jpeg_decoder_equals_pil(hw, layout, subsampling):
    """Gray, 4:4:4 and 4:2:0 files PIL writes, text-like and
    noise, decoded by the port as PIL decodes them, to the bit (the
    islow IDCT, fancy upsampling and libjpeg's colour tables)."""
    kw = {} if subsampling is None else {"subsampling": subsampling}
    for seed, kind, quality in ((hw[0], "smooth", 80), (hw[1] + 7, "noise", 35)):
        data = _pil_jpeg(_image(seed, hw, layout, kind), quality=quality, **kw)
        got = image_io.decode_jpeg(data)
        assert got.dtype == np.uint8 and np.array_equal(got, _pil_decoded(data))


@pytest.mark.parametrize("option", [{"restart_marker_blocks": 1},
                                    {"restart_marker_blocks": 3},
                                    {"restart_marker_rows": 1}])
def test_jpeg_decoder_with_restart_markers(option):
    img = _image(4, (45, 70), "rgb", "noise")
    data = _pil_jpeg(img, quality=90, **option)
    assert b"\xff\xdd" in data
    assert np.array_equal(image_io.decode_jpeg(io.BytesIO(data)), _pil_decoded(data))


@pytest.mark.parametrize("which", ["gray", "rgb"])
def test_jpeg_decoder_on_shipped_pages(which):
    """A shipped 1024x768 page and the RGB form, as PIL writes them and as
    the port's encoder writes them, decoded as PIL does."""
    import os

    from marie_tpu_torch.registry.zoo import ZOO_DIR

    with np.load(os.path.join(ZOO_DIR, "pages.npz")) as data:
        img = data["pages"][5] if which == "gray" else data["rgb"]
    for encoded in (_pil_jpeg(img, quality=80), image_io.encode_jpeg(img)):
        assert np.array_equal(image_io.decode_jpeg(encoded), _pil_decoded(encoded))


def test_jpeg_decoder_names_what_it_does_not_read():
    img = _image(2, (20, 20), "rgb", "noise")
    with pytest.raises(ValueError, match="progressive"):
        image_io.decode_jpeg(_pil_jpeg(img, progressive=True))
    with pytest.raises(ValueError, match="chroma sampling 2x1"):
        image_io.decode_jpeg(_pil_jpeg(img, subsampling=1))  # 4:2:2
    buf = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(buf, format="JPEG")
    with pytest.raises(ValueError, match="CMYK"):
        image_io.decode_jpeg(buf.getvalue())
    with pytest.raises(ValueError, match="not a JPEG"):
        image_io.decode_jpeg(b"GIF89a")


def _bmp(img, mode=None):
    buf = io.BytesIO()
    Image.fromarray(img).convert(mode or Image.fromarray(img).mode).save(buf, format="BMP")
    return buf.getvalue()


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "P"])
@pytest.mark.parametrize("hw", [(1, 1), (5, 7), (17, 23), (30, 41)])
def test_bmp_reader_equals_pil(mode, hw):
    """24-bit (RGB), 32-bit (RGBA) and 8-bit palette (L, P) files, rows
    padded to 4 bytes, as PIL's ``convert("RGB")`` reads them."""
    rng = np.random.default_rng(hw[0] * 31 + hw[1])
    data = _bmp(rng.integers(0, 256, hw + (4,), dtype=np.uint8), mode)
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert np.array_equal(image_io.read_bmp(io.BytesIO(data)), want)


def test_bmp_top_down_and_bitfields():
    import struct

    rng = np.random.default_rng(9)
    img = rng.integers(0, 256, (6, 5, 3), dtype=np.uint8)
    top_down = bytearray(_bmp(img))
    struct.pack_into("<i", top_down, 22, -6)
    want = np.asarray(Image.open(io.BytesIO(bytes(top_down))).convert("RGB"))
    assert np.array_equal(image_io.read_bmp(io.BytesIO(bytes(top_down))), want)
    assert np.array_equal(want, img[::-1])
    # 32-bit BI_BITFIELDS, masks after a 40-byte header (X8R8G8B8)
    px = np.concatenate([img[..., ::-1], np.zeros((6, 5, 1), np.uint8)], -1)[::-1]
    head = struct.pack("<IiiHHIIiiII", 40, 5, 6, 1, 32, 3, px.size, 2835, 2835, 0, 0)
    masks = struct.pack("<3I", 0xFF0000, 0xFF00, 0xFF)
    body = head + masks
    data = b"BM" + struct.pack("<IHHI", 14 + len(body) + px.size, 0, 0, 14 + len(body)) + body \
        + px.tobytes()
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert np.array_equal(want, img)
    assert np.array_equal(image_io.read_bmp(io.BytesIO(data)), img)


def _pil_g4(frame):
    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, format="TIFF", compression="group4")
    data = buf.getvalue()
    tags = Image.open(io.BytesIO(data)).tag_v2
    return data, [data[o:o + n] for o, n in zip(tags[273], tags[279])], tags[278]


def _bilevel(seed, hw, kind):
    rng = np.random.default_rng(seed)
    h, w = hw
    if kind == "noise":
        return rng.random(hw) < 0.5
    page = np.ones(hw, bool)  # white, with text-like black runs
    for _ in range(max(2, h * w // 300)):
        y, x = int(rng.integers(0, h)), int(rng.integers(0, w))
        page[y:y + int(rng.integers(1, 6)), x:x + int(rng.integers(1, 120))] = False
    return page


@pytest.mark.parametrize("hw,kind", [((1, 1), "noise"), ((7, 9), "noise"), ((40, 37), "text"),
                                     ((64, 301), "text"), ((30, 2900), "text"),
                                     ((33, 100), "noise")])
def test_g4_strips_equal_pils(hw, kind):
    """``write_tiff(compression="group4")`` gives the strips PIL and
    libtiff write for the same bool page (T.6's pass, vertical and
    horizontal modes, make-up codes past 2560), and the port reads
    them, and PIL's file, back."""
    frame = _bilevel(hw[0] * 7 + hw[1], hw, kind)
    data, strips, per_strip = _pil_g4(frame)
    assert per_strip == image_io.g4_rows_per_strip(hw[1], hw[0])
    buf = io.BytesIO()
    image_io.write_tiff(buf, [frame], compression="group4")
    ours = buf.getvalue()
    tags = Image.open(io.BytesIO(ours)).tag_v2
    assert [ours[o:o + n] for o, n in zip(tags[273], tags[279])] == strips
    assert np.array_equal(np.asarray(Image.open(io.BytesIO(ours))), frame)
    for blob in (data, ours):
        assert np.array_equal(image_io.read_tiff(io.BytesIO(blob))[0], frame * np.uint8(255))


def test_g4_on_a_letter_page_and_save_frames_as_tiff(tmp_path):
    """The 3300x2550 shipped page thresholded: several strips of 205 rows,
    equal to PIL's; ``save_frames_as_tiff`` writes bool frames as G4, as
    the JAX package does."""
    import os

    from marie_tpu_torch.registry.zoo import ZOO_DIR
    from marie_tpu_torch.utils.docs import save_frames_as_tiff

    with np.load(os.path.join(ZOO_DIR, "pages.npz")) as data:
        frame = data["oversize"] > 128
    _, strips, per_strip = _pil_g4(frame)
    assert per_strip == 205 and len(strips) == 17
    assert [image_io.encode_g4(frame[r:r + per_strip])
            for r in range(0, frame.shape[0], per_strip)] == strips
    path = str(tmp_path / "bundle.tif")
    save_frames_as_tiff([frame, frame[:40]], path)
    pages = [np.asarray(p) for p in ImageSequence.Iterator(Image.open(path))]
    assert np.array_equal(pages[0], frame) and np.array_equal(pages[1], frame[:40])
    with pytest.raises(ValueError, match="bool"):
        image_io.write_tiff(io.BytesIO(), [frame.astype(np.uint8)], compression="group4")


def _big_endian(data: bytes) -> bytes:
    """A little-endian baseline TIFF rewritten big-endian (8-bit or 1-bit
    samples: the pixel bytes stay as they are)."""
    import struct

    out = bytearray(data)
    out[:4] = b"MM\x00*"
    (ifd,) = struct.unpack("<I", data[4:8])
    struct.pack_into(">I", out, 4, ifd)
    sizes = {1: 1, 3: 2, 4: 4}
    while ifd:
        (count,) = struct.unpack("<H", data[ifd:ifd + 2])
        struct.pack_into(">H", out, ifd, count)
        for k in range(count):
            at = ifd + 2 + 12 * k
            tag, typ, n = struct.unpack("<HHI", data[at:at + 8])
            struct.pack_into(">HHI", out, at, tag, typ, n)
            code = {1: "B", 3: "H", 4: "I"}[typ]
            if n * sizes[typ] <= 4:
                vals = struct.unpack("<" + code * n, data[at + 8:at + 8 + n * sizes[typ]])
                struct.pack_into(">" + code * n, out, at + 8, *vals)
            else:
                (off,) = struct.unpack("<I", data[at + 8:at + 12])
                struct.pack_into(">I", out, at + 8, off)
                vals = struct.unpack("<" + code * n, data[off:off + n * sizes[typ]])
                struct.pack_into(">" + code * n, out, off, *vals)
        end = ifd + 2 + 12 * count
        (ifd,) = struct.unpack("<I", data[end:end + 4])
        struct.pack_into(">I", out, end, ifd)
    return bytes(out)


@pytest.mark.parametrize("layout", ["gray", "rgb", "bilevel_raw", "bilevel_packbits",
                                    "bilevel_g4"])
def test_big_endian_and_one_bit_tiff(layout):
    """PIL's little-endian files and the same files rewritten big-endian
    (which PIL reads as the same pixels) read by the port: 8-bit gray and
    RGB over several pages, and 1-bit pages uncompressed, PackBits and
    G4."""
    kind = layout.split("_")[-1]
    if layout in ("gray", "rgb"):
        frames = [_image(k, (21, 30), layout, "noise") for k in range(2)]
        compression = "packbits"
    else:
        frames = [_bilevel(k, (21, 30), "noise") for k in range(2)]
        compression = {"raw": None, "packbits": "packbits", "g4": "group4"}[kind]
    buf = io.BytesIO()
    imgs = [Image.fromarray(f) for f in frames]
    imgs[0].save(buf, format="TIFF", save_all=True, append_images=imgs[1:],
                 compression=compression)
    for data in (buf.getvalue(), _big_endian(buf.getvalue())):
        want = [np.asarray(p.convert("L" if p.mode == "1" else p.mode))
                for p in ImageSequence.Iterator(Image.open(io.BytesIO(data)))]
        got = image_io.read_tiff(io.BytesIO(data))
        assert len(got) == 2 and all(np.array_equal(g, w) for g, w in zip(got, want))


def test_one_bit_white_is_zero_tiff():
    """Photometric WhiteIsZero 1-bit pages read with 1 as black."""
    import struct

    frame = _bilevel(3, (9, 20), "noise")
    buf = io.BytesIO()
    image_io.write_tiff(buf, [frame], compression="raw")
    data = bytearray(buf.getvalue())
    (ifd,) = struct.unpack("<I", data[4:8])
    (count,) = struct.unpack("<H", data[ifd:ifd + 2])
    for k in range(count):
        at = ifd + 2 + 12 * k
        if struct.unpack("<H", data[at:at + 2])[0] == 262:
            struct.pack_into("<H", data, at + 8, 0)
    want = np.asarray(Image.open(io.BytesIO(bytes(data))).convert("L"))
    got = image_io.read_tiff(io.BytesIO(bytes(data)))[0]
    assert np.array_equal(got, want) and np.array_equal(got, (~frame) * np.uint8(255))


@pytest.mark.parametrize("mode", ["LA", "RGBA", "P"])
def test_png_with_alpha_or_palette(mode):
    """Colour types 4 and 6: the port reads the channels, and
    ``drop_alpha`` gives PIL's ``convert("L")`` / ``convert("RGB")``; a
    palette image (type 3) is refused."""
    rng = np.random.default_rng(len(mode))
    rgba = rng.integers(0, 256, (13, 17, 4), dtype=np.uint8)
    im = Image.fromarray(rgba, "RGBA").convert(mode)
    buf = io.BytesIO()
    im.save(buf, format="PNG")
    if mode == "P":
        with pytest.raises(ValueError, match="colour type 3"):
            image_io.read_png(io.BytesIO(buf.getvalue()))
        return
    got = image_io.read_png(io.BytesIO(buf.getvalue()))
    assert np.array_equal(got, np.asarray(im))
    target = "L" if mode == "LA" else "RGB"
    assert np.array_equal(image_io.drop_alpha(got), np.asarray(im.convert(target)))
    assert np.array_equal(image_io.read_image(io.BytesIO(buf.getvalue())), got)
