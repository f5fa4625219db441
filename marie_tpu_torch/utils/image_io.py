"""Image files in numpy and the standard library: the port's replacement
for the PIL calls of the JAX package's extract pipeline (the card has no
PIL).

* PNG (:func:`write_png`, :func:`read_png`): 8-bit gray and RGB.  The
  writer uses filter 0 on every row and ``zlib`` at PIL's level 6; the
  reader takes all five filter types (PIL writes adaptive filters).
* Multi-page TIFF (:func:`write_tiff`, :func:`read_tiff`): one strip a
  page, PackBits (each row packed on its own, as libtiff does) or
  uncompressed; 8-bit gray and RGB, and bool pages as 1-bit BlackIsZero.
  The reader takes several strips a page, as PIL writes them.
* Baseline JPEG (:func:`encode_jpeg`) at quality 80: RGB with 4:2:0
  chroma, as PIL encodes by default, libjpeg's fixed-point RGB -> YCbCr and 2x2 chroma
  average (alternating rounding bias 1, 2), libjpeg's edge replication
  and dummy blocks, its integer DCT (``jpeg_fdct_islow``) and
  libjpeg-turbo's reciprocal quantisation, libjpeg's quality scaling of
  the Annex K tables (clamped to 1..255), and the standard Huffman tables
  of Annex K.3.  It is vectorised over the whole image: the DCT's two
  passes run over every block at once, the run lengths and Huffman codes
  are arrays, and the bit string is packed through cumulative offsets,
  with ``0xFF`` stuffing.

Paths or open binary files are accepted wherever a file is read or
written.
"""

import io
import struct
import zlib
from typing import BinaryIO, List, Sequence, Union

import numpy as np

PathOrFile = Union[str, BinaryIO]
#: the quality the JAX package's PDF renderer asks PIL for
JPEG_QUALITY = 80
_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def _write_bytes(dst: PathOrFile, data: bytes) -> None:
    if isinstance(dst, str):
        with open(dst, "wb") as f:
            f.write(data)
    else:
        dst.write(data)


def _read_bytes(src: PathOrFile) -> bytes:
    if isinstance(src, str):
        with open(src, "rb") as f:
            return f.read()
    return src.read()


# --- PNG ----------------------------------------------------------------------

_PNG_COLOR = {1: 0, 3: 2}  # channels -> colour type
_PNG_CHANNELS = {v: k for k, v in _PNG_COLOR.items()}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(dst: PathOrFile, img: np.ndarray) -> None:
    """``img``: uint8 [H, W] gray or [H, W, 3] RGB."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    if (img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in _PNG_COLOR
            or 0 in img.shape[:2]):
        raise ValueError(f"PNG takes uint8 [H, W] or [H, W, 3], got {img.dtype} {img.shape}")
    h, w, c = img.shape
    raw = np.zeros((h, 1 + w * c), np.uint8)  # filter byte 0 on every row
    raw[:, 1:] = img.reshape(h, w * c)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _PNG_COLOR[c], 0, 0, 0)
    _write_bytes(dst, _PNG_SIG + _chunk(b"IHDR", ihdr)
                 + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                 + _chunk(b"IEND", b""))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """PNG scanlines [H, 1 + stride] -> [H, stride] (filters 0-4)."""
    h, stride = rows.shape[0], rows.shape[1] - 1
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:  # Sub: a running sum of each channel, mod 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur = line + prev
        elif kind in (3, 4):  # Avg, Paeth: sequential along the row
            cur_l = line.tolist()
            up = prev.tolist()
            for i in range(stride):
                left = cur_l[i - bpp] if i >= bpp else 0
                if kind == 3:
                    pred = (left + up[i]) >> 1
                else:
                    pred = _paeth(left, up[i], up[i - bpp] if i >= bpp else 0)
                cur_l[i] = (cur_l[i] + pred) & 0xFF
            cur = np.array(cur_l, np.uint8)
        else:
            raise ValueError(f"PNG filter type {kind}")
        out[y] = cur
        prev = cur
    return out


def read_png(src: PathOrFile) -> np.ndarray:
    """-> uint8 [H, W] (gray) or [H, W, 3] (RGB)."""
    data = _read_bytes(src)
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _, _, interlace = hdr
    if interlace or color not in _PNG_CHANNELS or depth != 8:
        raise ValueError(f"PNG depth {depth}, colour type {color}, interlace {interlace}")
    c = _PNG_CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = _unfilter(raw[:h * (w * c + 1)].reshape(h, w * c + 1), c)
    img = rows.reshape(h, w, c)
    return img[..., 0] if c == 1 else img


# --- TIFF ---------------------------------------------------------------------

_PACKBITS = 32773


def _packbits_rows(rows: np.ndarray) -> bytes:
    """PackBits of each row of a uint8 [R, N] array, rows packed on their
    own: runs of two or more equal bytes as replicate packets, the rest as
    literal packets, each at most 128 bytes."""
    r, n = rows.shape
    flat = rows.reshape(-1)
    total = flat.size
    if total == 0:
        return b""
    start = np.ones(total, bool)
    start[1:] = flat[1:] != flat[:-1]
    start[::n] = True
    starts = np.flatnonzero(start)
    lengths = np.diff(np.append(starts, total))
    single = lengths == 1

    def split(src, count):
        """Packets of at most 128 out of spans (src, count)."""
        k = (count + 127) // 128
        idx = np.repeat(np.arange(len(src)), k)
        first = np.cumsum(k) - k
        part = np.arange(idx.size) - np.repeat(first, k)
        p_src = src[idx] + part * 128
        p_cnt = np.minimum(count[idx] - part * 128, 128)
        return p_src, p_cnt

    rep_src, rep_cnt = split(starts[~single], lengths[~single])
    # literal spans: maximal chains of single runs within a row
    s_starts = starts[single]
    chain = np.ones(s_starts.size, bool)
    chain[1:] = (s_starts[1:] != s_starts[:-1] + 1) | (s_starts[1:] % n == 0)
    heads = np.flatnonzero(chain)
    lit_src, lit_cnt = split(s_starts[heads], np.diff(np.append(heads, s_starts.size)))

    src = np.concatenate([rep_src, lit_src])
    cnt = np.concatenate([rep_cnt, lit_cnt])
    lit = np.concatenate([np.zeros(rep_src.size, bool), np.ones(lit_src.size, bool)])
    order = np.argsort(src, kind="stable")
    src, cnt, lit = src[order], cnt[order], lit[order]
    size = np.where(lit, cnt + 1, 2)
    off = np.cumsum(size) - size
    out = np.empty(int(size.sum()), np.uint8)
    out[off] = np.where(lit, cnt - 1, 257 - cnt).astype(np.uint8)
    rep = ~lit
    out[off[rep] + 1] = flat[src[rep]]
    l_src, l_cnt, l_off = src[lit], cnt[lit], off[lit] + 1
    first = np.cumsum(l_cnt) - l_cnt
    within = np.arange(int(l_cnt.sum())) - np.repeat(first, l_cnt)
    out[np.repeat(l_off, l_cnt) + within] = flat[np.repeat(l_src, l_cnt) + within]
    return out.tobytes()


def _unpackbits_stream(data: bytes, size: int) -> bytes:
    out = bytearray()
    i, n = 0, len(data)
    while i < n and len(out) < size:
        h = data[i]
        if h < 128:
            out += data[i + 1:i + 2 + h]
            i += 2 + h
        elif h > 128:
            out += data[i + 1:i + 2] * (257 - h)
            i += 2
        else:
            i += 1
    return bytes(out)


def _tiff_page(img: np.ndarray):
    """(pixel rows [R, N] uint8, width, height, bits, samples, photometric)."""
    img = np.asarray(img)
    if img.dtype == np.bool_ and img.ndim == 2:
        return np.packbits(img, axis=1), img.shape[1], img.shape[0], 1, 1, 1
    if img.dtype != np.uint8:
        raise ValueError(f"TIFF takes uint8 or bool pages, got {img.dtype}")
    if img.ndim == 2:
        return img, img.shape[1], img.shape[0], 8, 1, 1
    if img.ndim == 3 and img.shape[2] == 3:
        h, w, _ = img.shape
        return img.reshape(h, w * 3), w, h, 8, 3, 2
    raise ValueError(f"TIFF takes [H, W] or [H, W, 3] uint8, or [H, W] bool, got {img.shape}")


def write_tiff(dst: PathOrFile, frames: Sequence[np.ndarray],
               compression: str = "packbits") -> None:
    """A (multi-page) little-endian TIFF, one strip a page."""
    if compression not in ("packbits", "raw"):
        raise ValueError(f"compression is 'packbits' or 'raw', got {compression!r}")
    if len(frames) == 0:
        raise ValueError("no frames")
    buf = bytearray(b"II*\x00\x00\x00\x00\x00")
    link = 4  # where the offset of the next IFD goes
    for frame in frames:
        rows, w, h, bits, spp, photometric = _tiff_page(frame)
        pixels = _packbits_rows(rows) if compression == "packbits" else rows.tobytes()
        if len(buf) % 2:
            buf += b"\x00"
        data_off = len(buf)
        buf += pixels
        extra_off = len(buf) + len(buf) % 2
        bits_value = bits if spp == 1 else extra_off
        tags = [
            (256, 4, 1, w), (257, 4, 1, h), (258, 3, spp, bits_value),
            (259, 3, 1, _PACKBITS if compression == "packbits" else 1),
            (262, 3, 1, photometric), (273, 4, 1, data_off), (277, 3, 1, spp),
            (278, 4, 1, h), (279, 4, 1, len(pixels)), (284, 3, 1, 1),
        ]
        if len(buf) % 2:
            buf += b"\x00"
        if spp > 1:
            buf += struct.pack(f"<{spp}H", *([bits] * spp))
            if len(buf) % 2:
                buf += b"\x00"
        ifd = len(buf)
        struct.pack_into("<I", buf, link, ifd)
        buf += struct.pack("<H", len(tags))
        for tag, typ, count, value in tags:
            fmt = "<HHIHH" if typ == 3 and count == 1 else "<HHII"
            buf += struct.pack(fmt, tag, typ, count, value, 0) if fmt == "<HHIHH" else \
                struct.pack(fmt, tag, typ, count, value)
        link = len(buf)
        buf += b"\x00\x00\x00\x00"
    _write_bytes(dst, bytes(buf))


_TIFF_TYPES = {1: ("B", 1), 3: ("H", 2), 4: ("I", 4), 16: ("Q", 8)}


def read_tiff(src: PathOrFile) -> List[np.ndarray]:
    """Every page of a little-endian TIFF: uint8 [H, W] (gray, and 1-bit
    BlackIsZero pages as 0/255) or [H, W, 3] (RGB); PackBits or
    uncompressed strips."""
    data = _read_bytes(src)
    if data[:4] != b"II*\x00":
        raise ValueError("not a little-endian TIFF file")
    (ifd,) = struct.unpack("<I", data[4:8])
    pages = []
    while ifd:
        (count,) = struct.unpack("<H", data[ifd:ifd + 2])
        tags = {}
        for k in range(count):
            at = ifd + 2 + 12 * k
            tag, typ, n, raw = struct.unpack("<HHI4s", data[at:at + 12])
            if typ not in _TIFF_TYPES:
                continue
            code, size = _TIFF_TYPES[typ]
            if n * size > 4:
                (off,) = struct.unpack("<I", raw)
                raw = data[off:off + n * size]
            tags[tag] = struct.unpack("<" + code * n, raw[:n * size])
        (ifd,) = struct.unpack("<I", data[ifd + 2 + 12 * count:ifd + 6 + 12 * count])
        w, h = tags[256][0], tags[257][0]
        bits = tags.get(258, (1,))[0]
        spp = tags.get(277, (1,))[0]
        comp = tags.get(259, (1,))[0]
        photometric = tags.get(262, (1,))[0]
        if comp not in (1, _PACKBITS) or bits not in (1, 8) or spp not in (1, 3) or (
                tags.get(284, (1,))[0] != 1) or photometric not in (1, 2):
            raise ValueError(f"TIFF compression {comp}, bits {bits}, samples {spp}, "
                             f"photometric {photometric}")
        stride = (w * spp * bits + 7) // 8
        rows_per_strip = tags.get(278, (h,))[0]
        strips = []
        for k, (off, n) in enumerate(zip(tags[273], tags[279])):
            rows = min(rows_per_strip, h - k * rows_per_strip)
            blob = data[off:off + n]
            strips.append(_unpackbits_stream(blob, rows * stride) if comp == _PACKBITS
                          else blob[:rows * stride])
        px = np.frombuffer(b"".join(strips), np.uint8)[:h * stride].reshape(h, stride)
        if bits == 1:
            px = np.unpackbits(px, axis=1)[:, :w] * np.uint8(255)
        img = px.reshape(h, w, spp) if spp == 3 else px.reshape(h, w)
        pages.append(np.ascontiguousarray(img))
    return pages


# --- JPEG ---------------------------------------------------------------------

_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

_Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_Q_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32)

# Annex K.3: code counts by length 1..16, then the symbols
_DC_LUMA = ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), tuple(range(12)))
_DC_CHROMA = ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0), tuple(range(12)))
_AC_LUMA = ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D), bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa"))
_AC_CHROMA = ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77), bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa"))


def _huffman_lookup(table):
    """(code [256], length [256]) by symbol (Annex C)."""
    counts, symbols = table
    code_of = np.zeros(256, np.int64)
    len_of = np.zeros(256, np.int64)
    code, k = 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            code_of[symbols[k]], len_of[symbols[k]] = code, length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


def _quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg's ``jpeg_quality_scaling`` and ``jpeg_add_quant_table``
    (baseline: 1..255), natural order."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    return np.clip((base * scale + 50) // 100, 1, 255)


# jfdctint.c's constants: CONST_BITS 13, PASS1_BITS 2
_CB, _P1 = 13, 2
_FIX = {k: int(v * (1 << _CB) + 0.5) for k, v in {
    "0_298631336": 0.298631336, "0_390180644": 0.390180644, "0_541196100": 0.541196100,
    "0_765366865": 0.765366865, "0_899976223": 0.899976223, "1_175875602": 1.175875602,
    "1_501321110": 1.501321110, "1_847759065": 1.847759065, "1_961570560": 1.961570560,
    "2_053119869": 2.053119869, "2_562915447": 2.562915447, "3_072711026": 3.072711026,
}.items()}


def _descale(x: np.ndarray, n: int) -> np.ndarray:
    return (x + (1 << (n - 1))) >> n


def _fdct_pass(d: List[np.ndarray], first: bool) -> List[np.ndarray]:
    """One pass of libjpeg's ``jpeg_fdct_islow`` (the LL&M integer DCT)
    over the 8 samples ``d[0..7]`` of every row (``first``) or column."""
    f = _FIX
    tmp0, tmp7 = d[0] + d[7], d[0] - d[7]
    tmp1, tmp6 = d[1] + d[6], d[1] - d[6]
    tmp2, tmp5 = d[2] + d[5], d[2] - d[5]
    tmp3, tmp4 = d[3] + d[4], d[3] - d[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    out = [None] * 8
    if first:
        out[0] = (tmp10 + tmp11) << _P1
        out[4] = (tmp10 - tmp11) << _P1
        n = _CB - _P1
    else:
        out[0] = _descale(tmp10 + tmp11, _P1)
        out[4] = _descale(tmp10 - tmp11, _P1)
        n = _CB + _P1
    z1 = (tmp12 + tmp13) * f["0_541196100"]
    out[2] = _descale(z1 + tmp13 * f["0_765366865"], n)
    out[6] = _descale(z1 - tmp12 * f["1_847759065"], n)
    z1, z2 = tmp4 + tmp7, tmp5 + tmp6
    z3, z4 = tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * f["1_175875602"]
    tmp4 = tmp4 * f["0_298631336"]
    tmp5 = tmp5 * f["2_053119869"]
    tmp6 = tmp6 * f["3_072711026"]
    tmp7 = tmp7 * f["1_501321110"]
    z1 = z1 * -f["0_899976223"]
    z2 = z2 * -f["2_562915447"]
    z3 = z3 * -f["1_961570560"] + z5
    z4 = z4 * -f["0_390180644"] + z5
    out[7] = _descale(tmp4 + z1 + z3, n)
    out[5] = _descale(tmp5 + z2 + z4, n)
    out[3] = _descale(tmp6 + z2 + z3, n)
    out[1] = _descale(tmp7 + z1 + z4, n)
    return out


def _quantised(plane: np.ndarray, q: np.ndarray) -> np.ndarray:
    """A component plane [8R, 8C] (samples 0..255) -> quantised
    coefficients [R, C, 64] in zig-zag order, as libjpeg-turbo computes
    them: the level shift, ``jpeg_fdct_islow`` (8x scaled), and division
    by ``8 q`` through the reciprocal, correction and shift of
    ``compute_reciprocal`` (16-bit ``DCTELEM``)."""
    r, c = plane.shape[0] // 8, plane.shape[1] // 8
    blocks = plane.reshape(r, 8, c, 8).transpose(0, 2, 1, 3).reshape(r * c, 64)
    # a flat block's DCT is its DC alone, 64 (v - 128) (most of a page)
    flat = blocks.min(axis=1) == blocks.max(axis=1)
    coef = np.zeros((64, r * c), np.int32)
    coef[0, flat] = 64 * (blocks[flat, 0].astype(np.int32) - 128)
    busy = np.flatnonzero(~flat)
    # [x, block, y] and then [y, u', block]: each pass reads 8 contiguous
    # planes (int32 holds every product, as in libjpeg-turbo)
    x = blocks[busy].reshape(-1, 8, 8).transpose(2, 0, 1).astype(np.int32) - 128
    x = np.stack(_fdct_pass(list(x), True))  # [u', block, y]
    x = np.ascontiguousarray(x.transpose(2, 0, 1))  # [y, u', block]
    coef[:, busy] = np.stack(_fdct_pass(list(x), False)).reshape(64, -1)
    coef = coef[_ZIGZAG]
    div = (q.astype(np.int64) << 3)[_ZIGZAG]
    b = np.floor(np.log2(div)).astype(np.int64)
    shift = 16 + b
    fq, fr = (np.int64(1) << shift) // div, (np.int64(1) << shift) % div
    corr = div // 2
    exact = fr == 0
    fq = np.where(exact, fq >> 1, np.where(fr <= div // 2, fq, fq + 1))
    shift = np.where(exact, shift - 1, shift)
    corr = np.where(~exact & (fr <= div // 2), corr + 1, corr)
    col = (slice(None), None)
    mag = ((np.abs(coef) + corr[col].astype(np.int32)) * fq[col].astype(np.int32)
           ) >> shift[col].astype(np.int32)
    return np.where(coef < 0, -mag, mag).T.reshape(r, c, 64)


def _ycc(rgb: np.ndarray):
    """libjpeg's ``rgb_ycc_convert``: 16-bit fixed point (int32 holds it)."""
    r, g, b = (rgb[..., k].astype(np.int32) for k in range(3))

    def fix(v):
        return int(v * 65536 + 0.5)

    half, off = 1 << 15, 128 << 16
    y = (fix(0.299) * r + fix(0.587) * g + fix(0.114) * b + half) >> 16
    cb = (-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b + off + half - 1) >> 16
    cr = (fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b + off + half - 1) >> 16
    return y, cb, cr


def _entropy_code(zz: np.ndarray, comp: np.ndarray, dc_tabs, ac_tabs) -> bytes:
    """Huffman-code blocks of zig-zagged coefficients [B, 64] in scan
    order (``comp``: each block's component) into the stuffed scan.

    A block's codes are its DC size and bits, then for each nonzero AC
    coefficient a ZRL per 16 zeros before it past the first 15 and its
    (run, size) symbol and bits, then EOB unless coefficient 63 is
    nonzero.  Each code's slot in the stream comes from cumulative counts,
    so the codes are written in place, block by block."""
    nb = zz.shape[0]
    luma = comp == 0
    (dl_code, dl_len), (dc_code, dc_len) = dc_tabs
    (al_code, al_len), (ac_code, ac_len) = ac_tabs

    def size_of(v):
        return np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)

    def extra_of(v, s):
        return np.where(v > 0, v, v + (np.int64(1) << s) - 1)

    dc = zz[:, 0]
    diff = np.empty_like(dc)
    for c in np.unique(comp):
        sel = np.flatnonzero(comp == c)
        diff[sel] = np.diff(dc[sel], prepend=0)
    nz = np.flatnonzero(zz)
    nz = nz[(nz & 63) != 0]  # AC coefficients only
    b, k = nz >> 6, nz & 63
    prev = np.concatenate([[0], k[:-1]])
    prev[np.concatenate([[True], b[1:] != b[:-1]])] = 0
    run = k - prev - 1
    zrl = run >> 4
    last = np.zeros(nb, np.int64)
    last[b] = k  # b ascends, so the last write per block is its last nonzero
    eob = last < 63
    # slots: the block's start, then its DC, its (ZRLs, symbol) groups, EOB
    per_nz = zrl + 1
    nz_in_block = np.bincount(b, weights=per_nz, minlength=nb).astype(np.int64)
    count = 1 + nz_in_block + eob
    start = np.cumsum(count) - count
    cs = np.cumsum(per_nz)
    sym_at = start[b] + cs - (np.cumsum(nz_in_block) - nz_in_block)[b]
    n = int(count.sum())
    code = np.zeros(n, np.int64)
    clen = np.zeros(n, np.int64)
    extra = np.zeros(n, np.int64)
    elen = np.zeros(n, np.int64)

    s = size_of(diff)
    code[start] = np.where(luma, dl_code[s], dc_code[s])
    clen[start] = np.where(luma, dl_len[s], dc_len[s])
    extra[start], elen[start] = extra_of(diff, s), s
    v = zz[b, k]
    s = size_of(v)
    sym = ((run & 15) << 4) | s
    lb = luma[b]
    code[sym_at] = np.where(lb, al_code[sym], ac_code[sym])
    clen[sym_at] = np.where(lb, al_len[sym], ac_len[sym])
    extra[sym_at], elen[sym_at] = extra_of(v, s), s
    zb = np.repeat(np.arange(b.size), zrl)
    if zb.size:
        first = np.cumsum(zrl) - zrl
        at = np.repeat(sym_at - zrl, zrl) + np.arange(zb.size) - np.repeat(first, zrl)
        code[at] = np.where(lb[zb], al_code[0xF0], ac_code[0xF0])
        clen[at] = np.where(lb[zb], al_len[0xF0], ac_len[0xF0])
    at = (start + count - 1)[eob]
    code[at] = np.where(luma[eob], al_code[0], ac_code[0])
    clen[at] = np.where(luma[eob], al_len[0], ac_len[0])

    value = (code << elen) | extra
    length = clen + elen
    # each code at its cumulative bit offset, in big-endian 32-bit words: a
    # code of at most 27 bits lies in one word or in two neighbours; the
    # pieces that share a word hold disjoint bits, so their sums, taken
    # 16 bits at a time (exact in float64), are their OR
    off = np.cumsum(length) - length
    total = int(off[-1] + length[-1])
    word = off >> 5
    end = (off & 31) + length
    split = end > 32
    first = np.where(split, value >> (end - 32), value << (32 - end))
    second = np.where(split, (value << (64 - end)) & 0xFFFFFFFF, 0)
    n_words = int(word[-1]) + 2
    packed = np.zeros(n_words, np.int64)
    for shift in (0, 16):
        half = np.bincount(word, weights=(first >> shift) & 0xFFFF, minlength=n_words)
        half += np.bincount(word + 1, weights=(second >> shift) & 0xFFFF, minlength=n_words)
        packed |= half.astype(np.int64) << shift
    packed = packed.astype(">u4")
    scan = np.frombuffer(packed.tobytes(), np.uint8)[:(total + 7) // 8].copy()
    if total % 8:  # the last byte is padded with 1s
        scan[-1] |= (1 << (8 - total % 8)) - 1
    ff = np.flatnonzero(scan == 0xFF)
    return np.insert(scan, ff + 1, 0).tobytes()


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def _dht(cls_id: int, table) -> bytes:
    counts, symbols = table
    return bytes([cls_id]) + bytes(counts) + bytes(symbols)


def encode_jpeg(img: np.ndarray) -> bytes:
    """Baseline JPEG at quality 80 of a uint8 [H, W, 3] RGB image, or of a
    [H, W] gray one encoded as its RGB stack would be, 4:2:0 chroma."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"JPEG takes uint8 [H, W] or [H, W, 3], got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    if h == 0 or w == 0 or h > 65535 or w > 65535:
        raise ValueError(f"JPEG size {h}x{w}")
    qy, qc = _quant_table(_Q_LUMA, JPEG_QUALITY), _quant_table(_Q_CHROMA, JPEG_QUALITY)
    mr, mc = -(-h // 16), -(-w // 16)  # MCUs of 16x16
    # luma: the edges replicated to whole blocks, then the MCU grid's blocks
    # past the image are libjpeg's dummy blocks: no AC, and the DC of the
    # block before them in the MCU (the left one at the right edge, the
    # upper right one in a bottom row)
    y = img if img.ndim == 2 else None
    if img.ndim == 3:
        y, cb, cr = _ycc(img)
    br, bc = -(-h // 8), -(-w // 8)
    zy = np.zeros((2 * mr, 2 * mc, 64), np.int32)
    zy[:br, :bc] = _quantised(np.pad(y, ((0, 8 * br - h), (0, 8 * bc - w)), mode="edge"), qy)
    if bc % 2:
        zy[:br, bc, 0] = zy[:br, bc - 1, 0]
    if br % 2:
        zy[br, :, 0] = zy[br - 1, 1::2, 0].repeat(2)
    zy = zy.reshape(mr, 2, mc, 2, 64).transpose(0, 2, 1, 3, 4).reshape(-1, 4, 64)
    if img.ndim == 2:
        # R = G = B: the fixed-point weights sum to 2^16 for Y and to 0 for
        # Cb and Cr, so Y is the gray value and every chroma block is 0
        zcb = zcr = np.zeros((mr * mc, 64), np.int32)
    else:
        # chroma: rows made even and columns made whole 16-wide blocks by
        # replication, the 2x2 average (bias 1, 2, 1, 2, ...), then the
        # last row replicated to whole blocks
        bias = np.tile(np.array([1, 2], np.int32), 4 * mc)[None, :]

        def chroma(c):
            c = np.pad(c, ((0, h % 2), (0, 16 * mc - w)), mode="edge")
            s = c.reshape(c.shape[0] // 2, 2, 8 * mc, 2).sum(axis=(1, 3))
            down = (s + bias) >> 2
            down = np.pad(down, ((0, 8 * mr - down.shape[0]), (0, 0)), mode="edge")
            return _quantised(down, qc).reshape(-1, 64)

        zcb, zcr = chroma(cb), chroma(cr)
    zz = np.concatenate([zy, zcb[:, None], zcr[:, None]], axis=1).reshape(-1, 64)
    comp = np.tile(np.array([0, 0, 0, 0, 1, 2]), zz.shape[0] // 6)
    scan = _entropy_code(
        zz, comp,
        (_huffman_lookup(_DC_LUMA), _huffman_lookup(_DC_CHROMA)),
        (_huffman_lookup(_AC_LUMA), _huffman_lookup(_AC_CHROMA)))
    out = io.BytesIO()
    out.write(b"\xff\xd8")
    out.write(_segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"))
    out.write(_segment(0xDB, b"\x00" + bytes(qy[_ZIGZAG].tolist())))
    out.write(_segment(0xDB, b"\x01" + bytes(qc[_ZIGZAG].tolist())))
    out.write(_segment(0xC0, struct.pack(">BHHB", 8, h, w, 3)
                       + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])))
    for cls_id, table in ((0x00, _DC_LUMA), (0x10, _AC_LUMA),
                          (0x01, _DC_CHROMA), (0x11, _AC_CHROMA)):
        out.write(_segment(0xC4, _dht(cls_id, table)))
    out.write(_segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])))
    out.write(scan)
    out.write(b"\xff\xd9")
    return out.getvalue()
