"""Image and bytes base64 codec (port of ``marie_tpu/utils/codec.py``): an
image as base64 text of a PNG and back (the job payload's ``srcBase64``
key, the HTTP clients).

The port writes its PNG with ``utils/image_io.py`` (filter 0 on every
row, zlib level 6), where PIL chooses adaptive filters: the base64 text
differs from the JAX package's, the pixels it decodes to do not.  PNG is
the one format written; :func:`base64_to_image` reads PNG, TIFF, baseline
JPEG and BMP (``image_io.read_image``)."""

import base64
import io
from typing import Optional

import numpy as np

from marie_tpu_torch.utils.image_io import read_image, write_png


def encode_to_base64(img: np.ndarray, format: str = "PNG") -> str:
    """An image array (uint8 [H, W] or [H, W, 3]) as base64 text of a PNG."""
    if format.upper() != "PNG":
        raise ValueError(f"encode_to_base64 writes PNG only, not {format!r}")
    buf = io.BytesIO()
    write_png(buf, np.asarray(img))
    return base64.b64encode(buf.getvalue()).decode()


def base64_to_bytes(data: Optional[str]) -> bytes:
    """Decode base64 text to raw bytes (None -> b'')."""
    if data is None:
        return b""
    return base64.b64decode(data.encode("utf-8"))


def base64_to_image(data: str) -> np.ndarray:
    """Decode base64 text holding an encoded image to an array."""
    return read_image(io.BytesIO(base64_to_bytes(data)))


# reference-style aliases
encodeToBase64 = encode_to_base64
base64StringToBytes = base64_to_bytes
