"""Document assets (port of ``save_frames_as_tiff`` and the frame readers
of ``marie_tpu/utils/docs.py``, through :mod:`marie_tpu_torch.utils.image_io`
instead of PIL)."""

import io
import os
from typing import List, Optional, Sequence

import numpy as np

from marie_tpu_torch.excepts import StorageError


def save_frames_as_tiff(frames: Sequence[np.ndarray], path: str) -> None:
    """Write frames as one multi-page TIFF: CCITT G4 when the first frame
    is bool (the strips PIL writes), PackBits otherwise, as the JAX
    package picks."""
    from marie_tpu_torch.utils.image_io import write_tiff

    frames = [np.asarray(f) for f in frames]
    write_tiff(path, frames,
               compression="group4" if frames[0].dtype == np.bool_ else "packbits")


def _rgb(img: np.ndarray) -> np.ndarray:
    """An image as PIL's ``convert("RGB")`` gives it: gray repeated into
    three channels, alpha dropped."""
    from marie_tpu_torch.utils.image_io import drop_alpha

    img = drop_alpha(np.asarray(img))
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    return np.ascontiguousarray(img.astype(np.uint8))


def frames_from_bytes(data: bytes, pages: Optional[Sequence[int]] = None,
                      hint: str = "") -> List[np.ndarray]:
    """A document file's bytes -> RGB uint8 frames (``pages``: 1-based
    page numbers to keep): every page of a TIFF, the image of a PNG, JPEG
    or BMP, read through :mod:`marie_tpu_torch.utils.image_io`."""
    from marie_tpu_torch.utils.image_io import read_image, read_tiff

    if data[:5] == b"%PDF-":
        raise StorageError("PDF rasterisation is not available; convert to multi-page "
                           "TIFF first")
    if data[:4] in (b"II*\x00", b"MM\x00*"):
        images = read_tiff(io.BytesIO(data))
    else:
        images = [read_image(io.BytesIO(data))]
    frames = [_rgb(img) for i, img in enumerate(images)
              if pages is None or (i + 1) in pages]
    if not frames:
        raise StorageError(f"no frames decoded from asset {hint!r}")
    return frames


def frames_from_file(path: str, pages: Optional[Sequence[int]] = None) -> List[np.ndarray]:
    """A document file -> RGB uint8 frames (1-based ``pages``)."""
    if not os.path.exists(path):
        raise StorageError(f"asset not found: {path}")
    with open(path, "rb") as fp:
        return frames_from_bytes(fp.read(), pages=pages, hint=path)


def frames_from_docs(docs) -> List[np.ndarray]:
    """Documents with tensors -> frames ([H, W] repeated into RGB)."""
    out = []
    for doc in docs:
        if doc.tensor is None:
            raise ValueError(f"doc {doc.id} has no tensor")
        arr = np.asarray(doc.tensor)
        if arr.ndim == 2:
            arr = np.stack([arr] * 3, -1)
        out.append(arr.astype(np.uint8))
    return out
