"""Image files in numpy and the standard library: the port's replacement
for the PIL calls of the JAX package's extract pipeline (the card has no
PIL).

* PNG (:func:`write_png`, :func:`read_png`): the writer takes 8-bit
  gray and RGB, with filter 0 on every row and ``zlib`` at PIL's level 6;
  the reader also takes gray + alpha and RGBA images and all five
  filter types (PIL writes adaptive filters).  :func:`drop_alpha`
  drops alpha as PIL's ``convert`` does.
* Multi-page TIFF (:func:`write_tiff`, :func:`read_tiff`): PackBits
  (each row packed on its own, as libtiff does) or uncompressed, one
  strip a page; 8-bit gray and RGB, and bool pages as 1-bit BlackIsZero,
  which ``"group4"`` writes as CCITT T.6 strips (:func:`encode_g4`, the
  bytes of libtiff's ``Fax3Encode2DRow``, in strips of Pillow's size).
  The reader takes little- and big-endian files, several strips a page,
  and 1-bit pages uncompressed, PackBits or G4 (:func:`decode_g4`).
* Baseline JPEG decoding (:func:`decode_jpeg`): gray, and YCbCr at
  4:4:4 and 4:2:0, with restart markers, equal to PIL's decode
  (libjpeg-turbo in its jpeg-6b mode) to the bit.
* BMP (:func:`read_bmp`): uncompressed 8-bit palette, 24- and 32-bit.
* :func:`read_image`: any of these readers, by the file's first bytes.
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

import bisect
import io
import struct
import zlib
from typing import BinaryIO, List, Sequence, Tuple, Union

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

_PNG_COLOR = {1: 0, 3: 2}  # channels -> colour type (what the writer writes)
#: colour type -> channels the reader takes: gray, RGB, gray + alpha, RGBA
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


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
    """-> uint8 [H, W] (gray), [H, W, 2] (gray + alpha), [H, W, 3] (RGB)
    or [H, W, 4] (RGBA); 8-bit samples, not interlaced.  :func:`drop_alpha` gives what PIL's
    ``convert("L")`` / ``convert("RGB")`` give."""
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


def drop_alpha(img: np.ndarray) -> np.ndarray:
    """An image without its alpha channel, as PIL's ``convert`` to ``L``
    or ``RGB`` drops it (no compositing): [H, W, 2] -> [H, W], [H, W, 4]
    -> [H, W, 3]; other images unchanged."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] in (2, 4):
        return np.ascontiguousarray(img[..., 0] if img.shape[2] == 2 else img[..., :3])
    return img


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


#: Pillow's strip size for the libtiff writer it uses for G4
G4_STRIP_BYTES = 65536
_COMPRESSION = {"raw": 1, "group4": 4, "packbits": _PACKBITS}


def g4_rows_per_strip(width: int, height: int) -> int:
    """Rows in each G4 strip, as Pillow sizes them: as many packed rows
    as fit in :data:`G4_STRIP_BYTES`, at least one."""
    stride = (width + 7) // 8
    return max(1, min(G4_STRIP_BYTES // stride, height))


def write_tiff(dst: PathOrFile, frames: Sequence[np.ndarray],
               compression: str = "packbits") -> None:
    """A (multi-page) little-endian TIFF.  ``"packbits"`` and ``"raw"``
    write one strip a page; ``"group4"`` takes bool pages only and writes
    them as CCITT T.6 strips of :func:`g4_rows_per_strip` rows (the bytes
    PIL and libtiff write)."""
    if compression not in _COMPRESSION:
        raise ValueError(f"compression is one of {sorted(_COMPRESSION)}, got {compression!r}")
    if len(frames) == 0:
        raise ValueError("no frames")
    buf = bytearray(b"II*\x00\x00\x00\x00\x00")
    link = 4  # where the offset of the next IFD goes

    def align():
        if len(buf) % 2:
            buf.extend(b"\x00")

    for frame in frames:
        frame = np.asarray(frame)
        rows, w, h, bits, spp, photometric = _tiff_page(frame)
        if compression == "group4":
            if frame.dtype != np.bool_:
                raise ValueError("group4 takes bool pages only")
            per_strip = g4_rows_per_strip(w, h)
            strips = [encode_g4(frame[r:r + per_strip]) for r in range(0, h, per_strip)]
        elif compression == "packbits":
            per_strip, strips = h, [_packbits_rows(rows)]
        else:
            per_strip, strips = h, [rows.tobytes()]
        offsets = []
        for strip in strips:
            align()
            offsets.append(len(buf))
            buf.extend(strip)
        align()
        extra = {}  # out-of-line values: tag -> offset
        for tag, values, code in ((258, [bits] * spp, "H"), (273, offsets, "I"),
                                  (279, [len(x) for x in strips], "I")):
            if len(values) > 1:
                extra[tag] = len(buf)
                buf.extend(struct.pack(f"<{len(values)}{code}", *values))
                align()
        tags = [
            (256, 4, 1, w), (257, 4, 1, h), (258, 3, spp, extra.get(258, bits)),
            (259, 3, 1, _COMPRESSION[compression]), (262, 3, 1, photometric),
            (273, 4, len(offsets), extra.get(273, offsets[0])), (277, 3, 1, spp),
            (278, 4, 1, per_strip), (279, 4, len(strips), extra.get(279, len(strips[0]))),
            (284, 3, 1, 1),
        ]
        ifd = len(buf)
        struct.pack_into("<I", buf, link, ifd)
        buf.extend(struct.pack("<H", len(tags)))
        for tag, typ, count, value in tags:
            if typ == 3 and count == 1:
                buf.extend(struct.pack("<HHIHH", tag, typ, count, value, 0))
            else:
                buf.extend(struct.pack("<HHII", tag, typ, count, value))
        link = len(buf)
        buf.extend(b"\x00\x00\x00\x00")
    _write_bytes(dst, bytes(buf))


_TIFF_TYPES = {1: ("B", 1), 3: ("H", 2), 4: ("I", 4), 16: ("Q", 8)}


def read_tiff(src: PathOrFile) -> List[np.ndarray]:
    """Every page of a TIFF, little- or big-endian: uint8 [H, W] (gray,
    and 1-bit pages as 0/255 by their photometric) or [H, W, 3] (RGB);
    uncompressed, PackBits or (1-bit) CCITT G4 strips."""
    data = _read_bytes(src)
    if data[:4] == b"II*\x00":
        end = "<"
    elif data[:4] == b"MM\x00*":
        end = ">"
    else:
        raise ValueError("not a TIFF file")
    (ifd,) = struct.unpack(end + "I", data[4:8])
    pages = []
    while ifd:
        (count,) = struct.unpack(end + "H", data[ifd:ifd + 2])
        tags = {}
        for k in range(count):
            at = ifd + 2 + 12 * k
            tag, typ, n, raw = struct.unpack(end + "HHI4s", data[at:at + 12])
            if typ not in _TIFF_TYPES:
                continue
            code, size = _TIFF_TYPES[typ]
            if n * size > 4:
                (off,) = struct.unpack(end + "I", raw)
                raw = data[off:off + n * size]
            tags[tag] = struct.unpack(end + code * n, raw[:n * size])
        (ifd,) = struct.unpack(end + "I", data[ifd + 2 + 12 * count:ifd + 6 + 12 * count])
        w, h = tags[256][0], tags[257][0]
        bits = tags.get(258, (1,))[0]
        spp = tags.get(277, (1,))[0]
        comp = tags.get(259, (1,))[0]
        photometric = tags.get(262, (1,))[0]
        planar = tags.get(284, (1,))[0]
        fill = tags.get(266, (1,))[0]
        if (comp not in (1, 4, _PACKBITS) or bits not in (1, 8) or spp not in (1, 3)
                or planar != 1 or photometric not in (0, 1, 2) or (comp == 4 and bits != 1)
                or fill != 1):
            raise ValueError(f"TIFF compression {comp}, bits {bits}, samples {spp}, "
                             f"planar {planar}, photometric {photometric}, fill order {fill}")
        stride = (w * spp * bits + 7) // 8
        rows_per_strip = min(tags.get(278, (h,))[0], h)
        strips = []
        for k, (off, n) in enumerate(zip(tags[273], tags[279])):
            rows = min(rows_per_strip, h - k * rows_per_strip)
            blob = data[off:off + n]
            if comp == 4:
                strips.append(np.packbits(decode_g4(blob, w, rows), axis=1).tobytes())
            elif comp == _PACKBITS:
                strips.append(_unpackbits_stream(blob, rows * stride))
            else:
                strips.append(blob[:rows * stride])
        px = np.frombuffer(b"".join(strips), np.uint8)[:h * stride].reshape(h, stride)
        if bits == 1:
            px = np.unpackbits(px, axis=1)[:, :w]
            px = (px if photometric == 1 else 1 - px) * np.uint8(255)
        elif photometric == 0:
            px = 255 - px
        img = px.reshape(h, w, spp) if spp == 3 else px.reshape(h, w)
        pages.append(np.ascontiguousarray(img))
    return pages


# --- CCITT T.6 (G4) -------------------------------------------------------------
#
# The codes of ITU-T T.4 (run lengths, Tables 2 and 3) and T.6 (modes,
# Table 1).  A code is (bits, length).  Bit 1 of a row is the "black" colour
# of the standard, as libtiff codes it (PIL's 1-bit pages: 1 = a white
# pixel, photometric BlackIsZero); every row starts on an imaginary 0.

_WHITE_TERM = (
    "00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 001000 "
    "000011 110100 110101 101010 101011 0100111 0001100 0001000 0010111 0000011 "
    "0000100 0101000 0101011 0010011 0100100 0011000 00000010 00000011 00011010 "
    "00011011 00010010 00010011 00010100 00010101 00010110 00010111 00101000 "
    "00101001 00101010 00101011 00101100 00101101 00000100 00000101 00001010 "
    "00001011 01010010 01010011 01010100 01010101 00100100 00100101 01011000 "
    "01011001 01011010 01011011 01001010 01001011 00110010 00110011 00110100")
_WHITE_MAKEUP = (  # 64, 128, ... 1728
    "11011 10010 010111 0110111 00110110 00110111 01100100 01100101 01101000 "
    "01100111 011001100 011001101 011010010 011010011 011010100 011010101 "
    "011010110 011010111 011011000 011011001 011011010 011011011 010011000 "
    "010011001 010011010 011000 010011011")
_BLACK_TERM = (
    "0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 0000101 "
    "0000111 00000100 00000111 000011000 0000010111 0000011000 0000001000 "
    "00001100111 00001101000 00001101100 00000110111 00000101000 00000010111 "
    "00000011000 000011001010 000011001011 000011001100 000011001101 "
    "000001101000 000001101001 000001101010 000001101011 000011010010 "
    "000011010011 000011010100 000011010101 000011010110 000011010111 "
    "000001101100 000001101101 000011011010 000011011011 000001010100 "
    "000001010101 000001010110 000001010111 000001100100 000001100101 "
    "000001010010 000001010011 000000100100 000000110111 000000111000 "
    "000000100111 000000101000 000001011000 000001011001 000000101011 "
    "000000101100 000001011010 000001100110 000001100111")
_BLACK_MAKEUP = (
    "0000001111 000011001000 000011001001 000001011011 000000110011 "
    "000000110100 000000110101 0000001101100 0000001101101 0000001001010 "
    "0000001001011 0000001001100 0000001001101 0000001110010 0000001110011 "
    "0000001110100 0000001110101 0000001110110 0000001110111 0000001010010 "
    "0000001010011 0000001010100 0000001010101 0000001011010 0000001011011 "
    "0000001100100 0000001100101")
_EXT_MAKEUP = (  # 1792, 1856, ... 2560, both colours
    "00000001000 00000001100 00000001101 000000010010 000000010011 000000010100 "
    "000000010101 000000010110 000000010111 000000011100 000000011101 "
    "000000011110 000000011111")


def _run_codes(term: str, makeup: str) -> List[Tuple[int, int]]:
    """(bits, length) by index: runs 0..63, then make-ups 64..2560 by 64."""
    return [(int(c, 2), len(c)) for c in (term + " " + makeup + " " + _EXT_MAKEUP).split()]


_RUN_CODES = (_run_codes(_WHITE_TERM, _WHITE_MAKEUP), _run_codes(_BLACK_TERM, _BLACK_MAKEUP))
_PASS, _HORIZ, _EOL = (0b0001, 4), (0b001, 3), (0b000000000001, 12)
#: vertical modes by a1 - b1 (VL3 .. V0 .. VR3)
_VERT = {-3: (0b0000010, 7), -2: (0b000010, 6), -1: (0b010, 3), 0: (0b1, 1),
         1: (0b011, 3), 2: (0b000011, 6), 3: (0b0000011, 7)}


def _put_run(out: list, run: int, colour: int) -> None:
    """libtiff's ``putspan``: 2560 make-ups while 2624 or more are left,
    then one make-up for the multiple of 64, then the terminating code."""
    codes = _RUN_CODES[colour]
    while run >= 2624:
        out.append(codes[63 + 40])
        run -= 2560
    if run >= 64:
        out.append(codes[63 + (run >> 6)])
        run &= 63
    out.append(codes[run])


def _row_changes(rows: np.ndarray) -> List[List[int]]:
    """Each row's changing elements (columns whose pixel differs from the
    one before; column 0 against an imaginary 0), computed for all rows
    at once."""
    r, w = rows.shape
    b = rows.astype(np.int8)
    diff = np.empty((r, w), bool)
    diff[:, 0] = b[:, 0] != 0
    diff[:, 1:] = b[:, 1:] != b[:, :-1]
    ys, xs = np.nonzero(diff)
    cuts = np.searchsorted(ys, np.arange(r + 1)).tolist()
    xs = xs.tolist()
    return [xs[cuts[i]:cuts[i + 1]] for i in range(r)]


def encode_g4(rows: np.ndarray) -> bytes:
    """One CCITT T.6 strip of bool rows [R, W] (True codes as the
    standard's black), as libtiff's ``Fax3Encode2DRow`` writes it: pass
    mode where b2 < a1, vertical where |a1 - b1| <= 3, else horizontal;
    the strip closed by EOFB and padded with 0 bits to a byte."""
    rows = np.asarray(rows, bool)
    w = rows.shape[1]
    out: List[Tuple[int, int]] = []
    ref: List[int] = []
    v0 = _VERT[0]
    for cur in _row_changes(rows):
        if cur == ref:  # every change (and the row's end) is V0
            out.extend([v0] * (len(cur) + 1))
            ref = cur
            continue
        na, nb = len(cur), len(ref)
        a0, colour = -1, 0
        while a0 < w:
            ia = bisect.bisect_right(cur, a0)
            a1 = cur[ia] if ia < na else w
            jb = bisect.bisect_right(ref, a0)
            jb += (jb & 1) != colour  # b1 changes to the colour opposite a0's
            b1 = ref[jb] if jb < nb else w
            b2 = ref[jb + 1] if jb + 1 < nb else w
            if b2 < a1:
                out.append(_PASS)
                a0 = b2
            elif -3 <= a1 - b1 <= 3:
                out.append(_VERT[a1 - b1])
                a0, colour = a1, 1 - colour
            else:
                a2 = cur[ia + 1] if ia + 1 < na else w
                out.append(_HORIZ)
                _put_run(out, a1 - max(a0, 0), colour)
                _put_run(out, a2 - a1, 1 - colour)
                a0 = a2
        ref = cur
    out.extend([_EOL, _EOL])
    value = np.array([c for c, _ in out], np.int64)
    length = np.array([n for _, n in out], np.int64)
    return _pack_codes(value, length, pad_ones=False).tobytes()


def _decode_table(codes: List[Tuple[int, int]], bits: int) -> List[int]:
    """A lookup by the next ``bits`` bits: index * 16 + code length (0:
    no code)."""
    table = [0] * (1 << bits)
    for index, (code, n) in enumerate(codes):
        lo = code << (bits - n)
        for k in range(lo, lo + (1 << (bits - n))):
            table[k] = index * 16 + n
    return table


_MODES = [_PASS, _HORIZ] + [_VERT[d] for d in range(-3, 4)]
_TABLES: dict = {}


def _g4_tables():
    if not _TABLES:
        _TABLES["mode"] = _decode_table(_MODES, 7)
        _TABLES["run"] = (_decode_table(_RUN_CODES[0], 13), _decode_table(_RUN_CODES[1], 13))
    return _TABLES["mode"], _TABLES["run"]


def decode_g4(data: bytes, width: int, height: int) -> np.ndarray:
    """One CCITT T.6 strip -> bool rows [height, width] (the standard's
    black as True)."""
    mode_tab, run_tabs = _g4_tables()
    buf = bytes(data) + b"\x00" * 8
    nbits = 8 * len(data)

    def peek(p: int, n: int) -> int:
        q = p >> 3
        v = (buf[q] << 16) | (buf[q + 1] << 8) | buf[q + 2]
        return (v >> (24 - n - (p & 7))) & ((1 << n) - 1)

    def run(p: int, colour: int):
        tab, total = run_tabs[colour], 0
        while True:
            e = tab[peek(p, 13)]
            if not e:
                raise ValueError("G4: bad run-length code")
            p += e & 15
            total += (e >> 4) if (e >> 4) < 64 else ((e >> 4) - 63) * 64
            if (e >> 4) < 64:
                return total, p

    ys: List[int] = []
    xs: List[int] = []
    ref: List[int] = []
    p = 0
    for y in range(height):
        cur: List[int] = []
        a0, colour, nb = -1, 0, len(ref)
        while a0 < width:
            if p >= nbits:
                raise ValueError("G4: the strip ends inside a row")
            e = mode_tab[peek(p, 7)]
            if not e:
                raise ValueError("G4: bad mode code (or an uncompressed extension)")
            p += e & 15
            mode = e >> 4
            jb = bisect.bisect_right(ref, a0)
            jb += (jb & 1) != colour
            b1 = ref[jb] if jb < nb else width
            if mode == 0:  # pass
                a0 = ref[jb + 1] if jb + 1 < nb else width
            elif mode == 1:  # horizontal
                r1, p = run(p, colour)
                r2, p = run(p, 1 - colour)
                a1 = max(a0, 0) + r1
                a2 = a1 + r2
                cur.extend(x for x in (a1, a2) if x < width)
                a0 = a2
            else:  # vertical
                a1 = b1 + mode - 5
                if a1 < width:
                    cur.append(a1)
                a0, colour = a1, 1 - colour
        ys.extend([y] * len(cur))
        xs.extend(cur)
        ref = cur
    toggles = np.zeros((height, width + 1), np.int8)
    toggles[np.array(ys, np.int64), np.array(xs, np.int64)] = 1
    return (np.cumsum(toggles, axis=1, dtype=np.int32)[:, :width] & 1).astype(bool)


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


def _pack_codes(value: np.ndarray, length: np.ndarray, pad_ones: bool) -> np.ndarray:
    """Codes ``value`` of ``length`` bits (each at most 27), most
    significant bit first, into bytes; the last byte padded with 1 bits
    (JPEG) or 0 bits.

    Each code goes at its cumulative bit offset, in big-endian 32-bit
    words: a code lies in one word or in two neighbours; the pieces that
    share a word hold disjoint bits, so their sums, taken 16 bits at a
    time (exact in float64), are their OR."""
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
    out = np.frombuffer(packed.tobytes(), np.uint8)[:(total + 7) // 8].copy()
    if total % 8 and pad_ones:
        out[-1] |= (1 << (8 - total % 8)) - 1
    return out


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

    scan = _pack_codes((code << elen) | extra, clen + elen, pad_ones=True)
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


# --- JPEG decoding --------------------------------------------------------------
#
# Baseline (and extended sequential) Huffman JPEG with 8-bit samples, as
# libjpeg-turbo decodes it in its jpeg-6b mode, which PIL uses: the
# integer "islow" inverse DCT (jidctint.c) with its range-limit table,
# "fancy" triangle upsampling of 2x2 (h2v2) chroma (jdsample.c, with its
# edge cases) and the fixed-point YCbCr -> RGB tables (jdcolor.c).
# Progressive, lossless, arithmetic-coded and 12-bit files, other
# subsamplings and CMYK raise ValueError.

_UNZIGZAG = np.argsort(_ZIGZAG)  # natural index -> zig-zag position

#: jidctint.c's post-IDCT range limit, indexed by the descaled value & 1023
_IDCT_LIMIT = np.concatenate([np.arange(128, 256), np.full(384, 255), np.zeros(384),
                              np.arange(0, 128)]).astype(np.uint8)

_SOF_NAMES = {0xC2: "progressive", 0xC3: "lossless", 0xC5: "differential sequential",
              0xC6: "differential progressive", 0xC7: "differential lossless",
              0xC9: "arithmetic-coded", 0xCA: "arithmetic-coded progressive",
              0xCB: "arithmetic-coded lossless", 0xCD: "arithmetic-coded differential",
              0xCE: "arithmetic-coded differential progressive",
              0xCF: "arithmetic-coded differential lossless"}


def _huffman_decode_table(counts: bytes, symbols: bytes) -> List[int]:
    """A lookup by the next 16 bits: symbol * 32 + code length (0: no
    code)."""
    table = [0] * 65536
    code, k = 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            lo = code << (16 - length)
            table[lo:lo + (1 << (16 - length))] = [symbols[k] * 32 + length] * (
                1 << (16 - length))
            code += 1
            k += 1
        code <<= 1
    return table


def _idct_pass(d: List[np.ndarray], n: int) -> List[np.ndarray]:
    """One pass of jidctint.c's ``jpeg_idct_islow`` over the 8 inputs of
    every column (pass 1, descaled by ``n`` = CONST_BITS - PASS1_BITS) or
    row (pass 2, by CONST_BITS + PASS1_BITS + 3)."""
    f = _FIX
    z1 = (d[2] + d[6]) * f["0_541196100"]
    tmp2 = z1 - d[6] * f["1_847759065"]
    tmp3 = z1 + d[2] * f["0_765366865"]
    tmp0 = (d[0] + d[4]) << _CB
    tmp1 = (d[0] - d[4]) << _CB
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = d[7], d[5], d[3], d[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * f["1_175875602"]
    t0 = t0 * f["0_298631336"]
    t1 = t1 * f["2_053119869"]
    t2 = t2 * f["3_072711026"]
    t3 = t3 * f["1_501321110"]
    z1 = z1 * -f["0_899976223"]
    z2 = z2 * -f["2_562915447"]
    z3 = z3 * -f["1_961570560"] + z5
    z4 = z4 * -f["0_390180644"] + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    return [_descale(v, n) for v in (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                                     tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


def _idct_islow(coef: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Dequantised inverse DCT of blocks [B, 64] (natural order) ->
    samples [B, 8, 8] uint8, libjpeg's integer arithmetic to the bit."""
    x = (coef.astype(np.int64) * q.astype(np.int64)).reshape(-1, 8, 8)  # [B, v, u]
    cols = _idct_pass(list(x.transpose(1, 0, 2)), _CB - _P1)  # 8 x [B, u] by row y
    ws = np.stack(cols, axis=1)  # [B, y, u]
    rows = _idct_pass(list(ws.transpose(2, 0, 1)), _CB + _P1 + 3)  # 8 x [B, y] by x
    return _IDCT_LIMIT[np.stack(rows, axis=2) & 1023]


def _fancy_h2v2(plane: np.ndarray, dw: int, dh: int) -> np.ndarray:
    """jdsample.c's ``h2v2_fancy_upsample``: each output row mixes its
    nearest input row 3:1 with the row above (even rows) or below (odd
    rows), the first and last real rows repeated past the edges, then each
    column 3:1 with its left or right neighbour (biases 8 and 7).  At most
    2 columns are doubled both ways instead, as libjpeg-turbo picks."""
    if dw <= 2:
        return np.repeat(np.repeat(plane[:dh, :dw], 2, axis=0), 2, axis=1)
    v = plane[:dh].astype(np.int32)
    above = np.concatenate([v[:1], v[:-1]])
    below = np.concatenate([v[1:], v[-1:]])
    out = np.empty((2 * dh, 2 * dw), np.int32)
    for parity, other in ((0, above), (1, below)):
        colsum = v * 3 + other  # [dh, cols]
        rows = out[parity::2]
        c = colsum[:, :dw]
        rows[:, 0] = (c[:, 0] * 4 + 8) >> 4
        rows[:, 2::2] = (c[:, 1:] * 3 + c[:, :-1] + 8) >> 4
        rows[:, 1:-1:2] = (c[:, :-1] * 3 + c[:, 1:] + 7) >> 4
        rows[:, -1] = (c[:, -1] * 4 + 7) >> 4
    return out.astype(np.uint8)


def _ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c's ``ycc_rgb_convert``: 16-bit fixed-point tables, each
    channel clamped to 0..255."""
    def fix(x):
        return int(x * 65536 + 0.5)

    half = 1 << 15
    x = np.arange(256, dtype=np.int64) - 128
    cr_r = (fix(1.40200) * x + half) >> 16
    cb_b = (fix(1.77200) * x + half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + half
    y = y.astype(np.int64)
    rgb = np.stack([y + cr_r[cr], y + ((cb_g[cb] + cr_g[cr]) >> 16), y + cb_b[cb]], axis=-1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _scan_segments(data: bytes, pos: int):
    """(entropy-coded intervals between restart markers, each unstuffed,
    and the position of the marker that ends the scan)."""
    arr = np.frombuffer(data, np.uint8)
    ff = np.flatnonzero(arr[pos:-1] == 0xFF) + pos
    nxt = arr[ff + 1]
    marker = (nxt != 0) & (nxt != 0xFF) & ~((nxt >= 0xD0) & (nxt <= 0xD7))
    end = int(ff[marker][0]) if marker.any() else len(data)
    rst = ff[(ff < end) & (nxt >= 0xD0) & (nxt <= 0xD7)]
    bounds = [pos] + [int(r) for r in rst] + [end]
    out = []
    for i, (a, b) in enumerate(zip(bounds[:-1], bounds[1:])):
        a += 2 if i else 0  # skip the RSTn marker itself
        seg = arr[a:b]
        stuffed = np.flatnonzero(seg[:-1] == 0xFF) + 1
        out.append(np.delete(seg, stuffed[seg[stuffed] == 0]).tobytes())
    return out, end


def _decode_interval(seg: bytes, blocks: list):
    """Huffman-decode one restart interval: ``blocks`` lists (block slot,
    DC table, AC table) in scan order.  Returns (slots, positions, sizes)
    of the DC differences and (slots, zig-zag index, positions, sizes) of
    the nonzero AC coefficients: bit offsets of their extra bits."""
    buf = seg + b"\x00" * 8  # libjpeg reads zeros past the data
    dc_s, dc_p, dc_n = [], [], []
    ac_s, ac_k, ac_p, ac_n = [], [], [], []
    p = 0
    for slot, dct, act in blocks:
        q = p >> 3
        w = (((buf[q] << 16) | (buf[q + 1] << 8) | buf[q + 2]) >> (8 - (p & 7))) & 0xFFFF
        e = dct[w]
        if not e:
            raise ValueError("JPEG: bad Huffman code")
        p += e & 31
        s = e >> 5
        dc_s.append(slot)
        dc_p.append(p)
        dc_n.append(s)
        p += s
        k = 1
        while k < 64:
            q = p >> 3
            w = (((buf[q] << 16) | (buf[q + 1] << 8) | buf[q + 2]) >> (8 - (p & 7))) & 0xFFFF
            e = act[w]
            if not e:
                raise ValueError("JPEG: bad Huffman code")
            p += e & 31
            rs = e >> 5
            s = rs & 15
            if s:
                k += rs >> 4
                if k > 63:
                    raise ValueError("JPEG: coefficient index past 63")
                ac_s.append(slot)
                ac_k.append(k)
                ac_p.append(p)
                ac_n.append(s)
                p += s
                k += 1
            elif rs == 0xF0:
                k += 16
            else:
                break
    return (dc_s, dc_p, dc_n), (ac_s, ac_k, ac_p, ac_n)


def _extend(seg: bytes, pos: np.ndarray, size: np.ndarray) -> np.ndarray:
    """The signed values of the ``size``-bit fields at bit offsets ``pos``
    (JPEG's EXTEND; size 0 is 0)."""
    arr = np.frombuffer(seg + b"\x00" * 4, np.uint8).astype(np.int64)
    q = pos >> 3
    word = (arr[q] << 24) | (arr[q + 1] << 16) | (arr[q + 2] << 8) | arr[q + 3]
    raw = (word >> (32 - (pos & 7) - size)) & ((1 << size) - 1)
    return np.where((size > 0) & (raw < (1 << np.maximum(size - 1, 0))),
                    raw - (1 << size) + 1, raw)


def decode_jpeg(src: Union[PathOrFile, bytes]) -> np.ndarray:
    """A baseline JPEG -> uint8 [H, W] (one component) or [H, W, 3] (RGB
    from YCbCr, or RGB as stored where the file says so), equal to PIL's
    decode to the bit."""
    data = bytes(src) if isinstance(src, (bytes, bytearray, memoryview)) else _read_bytes(src)
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file")
    qt, dc_t, ac_t = {}, {}, {}
    frame = None
    restart, adobe, jfif = 0, None, False
    coef = None
    pos = 2
    while pos < len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"JPEG: no marker at byte {pos}")
        marker = data[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        if marker == 0xD9:
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            pos += 2
            continue
        (n,) = struct.unpack(">H", data[pos + 2:pos + 4])
        body = data[pos + 4:pos + 2 + n]
        pos += 2 + n
        if marker in _SOF_NAMES:
            raise ValueError(f"JPEG: {_SOF_NAMES[marker]} files are not read "
                             "(baseline Huffman only)")
        if marker == 0xDB:
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                if pq:
                    vals = struct.unpack(">64H", body[i + 1:i + 129])
                    i += 129
                else:
                    vals = tuple(body[i + 1:i + 65])
                    i += 65
                qt[tq] = np.array(vals, np.int64)[_UNZIGZAG]  # natural order
        elif marker == 0xC4:
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                counts = body[i + 1:i + 17]
                syms = body[i + 17:i + 17 + sum(counts)]
                (ac_t if tc else dc_t)[th] = _huffman_decode_table(counts, syms)
                i += 17 + sum(counts)
        elif marker in (0xC0, 0xC1):
            precision, h, w, nc = struct.unpack(">BHHB", body[:6])
            if precision != 8:
                raise ValueError(f"JPEG: {precision}-bit samples are not read")
            if h == 0:
                raise ValueError("JPEG: a height given by a DNL marker is not read")
            comps = [(body[6 + 3 * i], body[7 + 3 * i] >> 4, body[7 + 3 * i] & 15,
                      body[8 + 3 * i]) for i in range(nc)]
            if nc not in (1, 3):
                raise ValueError(f"JPEG: {nc} components (CMYK, YCCK) are not read")
            if nc == 1:
                comps = [(comps[0][0], 1, 1, comps[0][3])]
            hmax = max(c[1] for c in comps)
            vmax = max(c[2] for c in comps)
            mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
            frame = (h, w, comps, hmax, vmax, mcux, mcuy)
            coef = [np.zeros((mcuy * c[2] * mcux * c[1], 64), np.int64) for c in comps]
        elif marker == 0xDD:
            (restart,) = struct.unpack(">H", body[:2])
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe = body[11]
        elif marker == 0xE0 and body[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xDA:
            if frame is None:
                raise ValueError("JPEG: scan before frame header")
            pos = _decode_scan(data, pos, body, frame, coef, dc_t, ac_t, restart)
    if frame is None:
        raise ValueError("JPEG without a frame header")
    h, w, comps, hmax, vmax, mcux, mcuy = frame
    planes = []
    for (cid, hs, vs, tq), c in zip(comps, coef):
        bw, bh = mcux * hs, mcuy * vs
        px = _idct_islow(c, qt[tq]).reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3)
        px = px.reshape(bh * 8, bw * 8)
        dw, dh = -(-w * hs // hmax), -(-h * vs // vmax)
        if (hs, vs) == (hmax, vmax):
            full = px[:dh, :dw]
        elif (hmax, vmax) == (2 * hs, 2 * vs):
            full = _fancy_h2v2(px, dw, dh)
        else:
            raise ValueError(f"JPEG: chroma sampling {hmax}x{vmax} over {hs}x{vs} is not read")
        planes.append(full[:h, :w])
    if len(planes) == 1:
        return np.ascontiguousarray(planes[0])
    ids = tuple(c[0] for c in comps)
    rgb_stored = (adobe == 0) if adobe is not None else (not jfif and ids == (82, 71, 66))
    if rgb_stored:
        return np.ascontiguousarray(np.stack(planes, axis=-1))
    return _ycc_to_rgb(*planes)


def _decode_scan(data, pos, header, frame, coef, dc_t, ac_t, restart) -> int:
    """Decode one scan into ``coef`` (per component, zig-zag order
    converted to natural); returns the position after the scan's data."""
    h, w, comps, hmax, vmax, mcux, mcuy = frame
    ns = header[0]
    spec = [(header[1 + 2 * i], header[2 + 2 * i] >> 4, header[2 + 2 * i] & 15)
            for i in range(ns)]
    ss, se, ahl = header[1 + 2 * ns], header[2 + 2 * ns], header[3 + 2 * ns]
    if (ss, se, ahl) != (0, 63, 0):
        raise ValueError("JPEG: a spectral-selection or successive-approximation scan")
    index = {c[0]: i for i, c in enumerate(comps)}
    blocks = []  # (component, block slot, DC table, AC table) in scan order
    if ns == 1:
        ci = index[spec[0][0]]
        _, hs, vs, _ = comps[ci]
        bw = mcux * hs
        cw = -(-(-(-w * hs // hmax)) // 8)
        ch = -(-(-(-h * vs // vmax)) // 8)
        for by in range(ch):
            for bx in range(cw):
                blocks.append((ci, by * bw + bx, spec[0][1], spec[0][2]))
    else:
        for my in range(mcuy):
            for mx in range(mcux):
                for cid, td, ta in spec:
                    ci = index[cid]
                    _, hs, vs, _ = comps[ci]
                    bw = mcux * hs
                    for v in range(vs):
                        for u in range(hs):
                            blocks.append((ci, (my * vs + v) * bw + mx * hs + u, td, ta))
    per_mcu = 1 if ns == 1 else sum(comps[index[c]][1] * comps[index[c]][2] for c, _, _ in spec)
    segs, end = _scan_segments(data, pos)
    step = restart * per_mcu if restart else len(blocks)
    for i, seg in enumerate(segs):
        chunk = blocks[i * step:(i + 1) * step]
        if not chunk:
            break
        slots = [(ci * (1 << 40)) + slot for ci, slot, _, _ in chunk]
        (dcs, dcp, dcn), (acs, ack, acp, acn) = _decode_interval(
            seg, [(s, dc_t[td], ac_t[ta]) for s, (_, _, td, ta) in zip(slots, chunk)])
        comp_of = np.array([ci for ci, _, _, _ in chunk], np.int64)
        diff = _extend(seg, np.array(dcp, np.int64), np.array(dcn, np.int64))
        for ci in np.unique(comp_of):
            sel = comp_of == ci  # DC predictions restart in every interval
            coef[ci][np.array(dcs, np.int64)[sel] & ((1 << 40) - 1), 0] = np.cumsum(diff[sel])
        if acs:
            acs = np.array(acs, np.int64)
            vals = _extend(seg, np.array(acp, np.int64), np.array(acn, np.int64))
            nat = _ZIGZAG[np.array(ack, np.int64)]
            comp = acs >> 40
            for ci in np.unique(comp):
                sel = comp == ci
                coef[ci][acs[sel] & ((1 << 40) - 1), nat[sel]] = vals[sel]
    return end


# --- BMP ------------------------------------------------------------------------


def read_bmp(src: PathOrFile) -> np.ndarray:
    """An uncompressed BMP -> uint8 [H, W, 3] RGB: 24-bit, 32-bit (the
    fourth byte dropped, or channels by their BI_BITFIELDS masks) and
    8-bit palette files, bottom-up or top-down rows, as PIL's
    ``convert("RGB")`` gives them."""
    data = _read_bytes(src)
    if data[:2] != b"BM":
        raise ValueError("not a BMP file")
    (pixels_at,) = struct.unpack("<I", data[10:14])
    (header,) = struct.unpack("<I", data[14:18])
    if header < 40:
        raise ValueError(f"BMP: a {header}-byte (OS/2) header is not read")
    w, h, _, bpp, compression = struct.unpack("<iiHHI", data[18:34])
    (colors,) = struct.unpack("<I", data[46:50])
    top_down = h < 0
    h = abs(h)
    if bpp not in (8, 24, 32) or compression not in (0, 3, 6) or (
            compression and bpp != 32):
        raise ValueError(f"BMP: {bpp}-bit, compression {compression} is not read")
    stride = (w * bpp + 31) // 32 * 4
    rows = np.frombuffer(data, np.uint8, count=stride * h, offset=pixels_at).reshape(h, stride)
    if not top_down:
        rows = rows[::-1]
    if bpp == 8:
        n = colors or 256
        table = np.frombuffer(data, np.uint8, count=n * 4, offset=14 + header)
        palette = np.zeros((256, 3), np.uint8)
        palette[:n] = table.reshape(n, 4)[:, 2::-1]  # BGRX -> RGB
        return np.ascontiguousarray(palette[rows[:, :w]])
    px = rows[:, :w * bpp // 8].reshape(h, w, bpp // 8)
    if compression == 0:
        return np.ascontiguousarray(px[..., 2::-1])
    masks = struct.unpack("<3I", data[54:66])  # red, green, blue
    word = px.view("<u4")[..., 0].astype(np.int64)
    out = []
    for m in masks:
        shift = (m & -m).bit_length() - 1
        if m >> shift != 0xFF:
            raise ValueError(f"BMP: channel mask {m:#x} is not 8 bits wide")
        out.append((word >> shift) & 0xFF)
    return np.stack(out, axis=-1).astype(np.uint8)


def read_image(src: PathOrFile) -> np.ndarray:
    """An image file by its first bytes: PNG, TIFF (the first page),
    baseline JPEG or BMP; as :func:`read_png` etc. return it."""
    data = _read_bytes(src)
    if data[:8] == _PNG_SIG:
        return read_png(io.BytesIO(data))
    if data[:4] in (b"II*\x00", b"MM\x00*"):
        return read_tiff(io.BytesIO(data))[0]
    if data[:3] == b"\xff\xd8\xff":
        return decode_jpeg(data)
    if data[:2] == b"BM":
        return read_bmp(io.BytesIO(data))
    raise ValueError(f"an image file of PNG, TIFF, JPEG or BMP, not one starting {data[:8]!r}")
