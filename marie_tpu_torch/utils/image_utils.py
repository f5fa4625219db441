"""Image helpers (copy of ``hash_frames_fast`` of
``marie_tpu/utils/image_utils.py``)."""

import hashlib
from typing import Sequence

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
