"""Document assets (port of ``save_frames_as_tiff`` of
``marie_tpu/utils/docs.py``, written through
:mod:`marie_tpu_torch.utils.image_io` instead of PIL)."""

from typing import Sequence

import numpy as np


def save_frames_as_tiff(frames: Sequence[np.ndarray], path: str) -> None:
    """Write frames as one multi-page PackBits TIFF (bool frames 1-bit;
    the JAX package writes those as CCITT G4)."""
    from marie_tpu_torch.utils.image_io import write_tiff

    write_tiff(path, [np.asarray(f) for f in frames])
