"""Document assets (port of ``save_frames_as_tiff`` of
``marie_tpu/utils/docs.py``, written through
:mod:`marie_tpu_torch.utils.image_io` instead of PIL)."""

from typing import Sequence

import numpy as np


def save_frames_as_tiff(frames: Sequence[np.ndarray], path: str) -> None:
    """Write frames as one multi-page TIFF: CCITT G4 when the first frame
    is bool (the strips PIL writes), PackBits otherwise, as the JAX
    package picks."""
    from marie_tpu_torch.utils.image_io import write_tiff

    frames = [np.asarray(f) for f in frames]
    write_tiff(path, frames,
               compression="group4" if frames[0].dtype == np.bool_ else "packbits")
