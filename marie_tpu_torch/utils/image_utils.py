"""Image helpers (copy of ``hash_frames_fast`` and ``ensure_max_page_size``
of ``marie_tpu/utils/image_utils.py``; the resize is
:func:`marie_tpu_torch.preprocess.resize.resize_area_u8`, cv2's
``INTER_AREA`` bits in numpy)."""

import hashlib
from typing import Sequence, Tuple

import numpy as np


def hash_frames_fast(frames: Sequence[np.ndarray]) -> str:
    """Stable checksum of a frame list, the pipelines' asset key: sha256
    over every frame's rows at a stride of ``H // 64`` and its shape, as
    the JAX package computes it, so that both packages find each other's
    OCR cache."""
    h = hashlib.sha256()
    for f in frames:
        h.update(np.ascontiguousarray(f[:: max(f.shape[0] // 64, 1)]).tobytes())
        h.update(str(f.shape).encode())
    return h.hexdigest()[:32]


def ensure_max_page_size(
    image: np.ndarray, max_h: int = 3000, max_w: int = 3000
) -> Tuple[np.ndarray, float]:
    """Downscale oversized pages; returns (image, scale_applied<=1)."""
    from marie_tpu_torch.preprocess.resize import resize_area_u8

    h, w = image.shape[:2]
    scale = min(max_h / h, max_w / w, 1.0)
    if scale >= 1.0:
        return image, 1.0
    return resize_area_u8(image, (int(w * scale), int(h * scale))), scale
