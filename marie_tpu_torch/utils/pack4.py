"""Packed grayscale page uploads (port of ``marie_tpu/utils/pack4.py``):
``u4`` (16 levels), ``u2`` (4 levels), ``u1`` (binarised at 128) and
``u1d`` (8x8 Bayer ordered dither, the ``u1`` wire format).  The engine
packs pages on the host before their upload; the fused program unpacks
them on the device (``ocr/fused.py``).

These are the numpy versions of the JAX package's packers, which that
package uses where its native library (``native/pack``) is absent; the
port uses no native library.  Both give the same bytes.
"""

import numpy as np


def pack4(pages: np.ndarray) -> np.ndarray:
    """[..., W] uint8 (W even) -> [..., W//2] packed nibbles (rounded),
    high nibble first: nibble = round(v / 17), the inverse of the
    device's ``nibble * 17``."""
    pages = np.ascontiguousarray(pages, dtype=np.uint8)
    if pages.shape[-1] % 2:
        raise ValueError(f"last dim must be even, got {pages.shape}")
    q = ((pages.astype(np.uint16) + 8) // 17).astype(np.uint8)
    return (q[..., 0::2] << 4) | q[..., 1::2]


def unpack4_host(packed: np.ndarray) -> np.ndarray:
    """Host-side inverse of :func:`pack4`: [..., W//2] -> [..., W] uint8."""
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    hi = (packed >> 4) * np.uint8(17)
    lo = (packed & 0xF) * np.uint8(17)
    return np.stack([hi, lo], axis=-1).reshape(
        packed.shape[:-1] + (packed.shape[-1] * 2,))


def pack2(pages: np.ndarray) -> np.ndarray:
    """[..., W] uint8 (W % 4 == 0) -> [..., W//4] 2-bit packed (rounded),
    most significant pair first.  Four gray levels (0, 85, 170, 255)."""
    pages = np.ascontiguousarray(pages, dtype=np.uint8)
    if pages.shape[-1] % 4:
        raise ValueError(f"last dim must be divisible by 4, got {pages.shape}")
    q = ((pages.astype(np.uint16) + 42) // 85).astype(np.uint8)
    return (
        (q[..., 0::4] << 6) | (q[..., 1::4] << 4)
        | (q[..., 2::4] << 2) | q[..., 3::4]
    )


def unpack2_host(packed: np.ndarray) -> np.ndarray:
    """Host-side inverse of :func:`pack2`: [..., W//4] -> [..., W] uint8."""
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    parts = [((packed >> s) & 3) * np.uint8(85) for s in (6, 4, 2, 0)]
    return np.stack(parts, axis=-1).reshape(
        packed.shape[:-1] + (packed.shape[-1] * 4,))


def pack1(pages: np.ndarray) -> np.ndarray:
    """[..., W] uint8 (W % 8 == 0) -> [..., W//8] 1-bit packed, binarised
    at 128 (levels 0, 255), most significant bit first."""
    pages = np.ascontiguousarray(pages, dtype=np.uint8)
    if pages.shape[-1] % 8:
        raise ValueError(f"last dim must be divisible by 8, got {pages.shape}")
    bits = (pages >= 128).astype(np.uint8)
    return np.packbits(bits.reshape(bits.shape[:-1] + (-1, 8)),
                       axis=-1, bitorder="big").reshape(
        pages.shape[:-1] + (pages.shape[-1] // 8,))


# 8x8 Bayer matrix (standard ordered-dither index pattern)
_BAYER8 = np.array(
    [
        [0, 32, 8, 40, 2, 34, 10, 42],
        [48, 16, 56, 24, 50, 18, 58, 26],
        [12, 44, 4, 36, 14, 46, 6, 38],
        [60, 28, 52, 20, 62, 30, 54, 22],
        [3, 35, 11, 43, 1, 33, 9, 41],
        [51, 19, 59, 27, 49, 17, 57, 25],
        [15, 47, 7, 39, 13, 45, 5, 37],
        [63, 31, 55, 23, 61, 29, 53, 21],
    ],
    np.uint8,
)
#: per-position thresholds in 0..255 ((b + 0.5) * 4 - 0.5 rounded)
_BAYER8_T = (_BAYER8.astype(np.uint16) * 4 + 1).astype(np.uint8)


def pack1d(pages: np.ndarray) -> np.ndarray:
    """[..., H, W] uint8 (W % 8 == 0) -> [..., H, W//8] 1-bit packed with
    ordered (8x8 Bayer) dithering: the :func:`pack1` wire format, but gray
    levels survive as spatial bit density, which the crop resampling and
    the detector's stem average back into approximate grayscale."""
    pages = np.ascontiguousarray(pages, dtype=np.uint8)
    if pages.shape[-1] % 8:
        raise ValueError(f"last dim must be divisible by 8, got {pages.shape}")
    h, w = pages.shape[-2], pages.shape[-1]
    thresh = np.tile(_BAYER8_T, ((h + 7) // 8, (w + 7) // 8))[:h, :w]
    bits = (pages > thresh).astype(np.uint8)
    return np.packbits(
        bits.reshape(bits.shape[:-1] + (-1, 8)), axis=-1, bitorder="big"
    ).reshape(pages.shape[:-1] + (w // 8,))


def unpack1_host(packed: np.ndarray) -> np.ndarray:
    """Host-side inverse of :func:`pack1`: [..., W//8] -> [..., W] uint8."""
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    bits = np.unpackbits(packed[..., None], axis=-1, bitorder="big")
    return bits.reshape(packed.shape[:-1] + (packed.shape[-1] * 8,)) * np.uint8(255)


#: upload format -> (packer, bits per pixel on the wire)
PACKERS = {"u4": (pack4, 4), "u2": (pack2, 2), "u1": (pack1, 1), "u1d": (pack1d, 1)}
