"""Static-shape page buckets (copy of ``marie_tpu/preprocess/buckets.py``).

Pages are padded into a small fixed set of (H, W) buckets so every batch
of the page program has one of a few shapes.  Pure numpy; the port keeps
its own copy so that it imports nothing of the JAX package.
"""

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

# (H, W) page buckets — portrait-dominant document scans at 300dpi-ish
PAGE_BUCKETS: Tuple[Tuple[int, int], ...] = (
    (768, 576),
    (1024, 768),
    (1280, 1024),
    (1536, 1152),
    (2048, 1536),
)

# recognition crop widths at fixed height (see TrOCRConfig.fast 48×320)
CROP_WIDTH_BUCKETS: Tuple[int, ...] = (64, 128, 192, 320)


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """A set of static shapes plus padding policy."""

    shapes: Tuple[Tuple[int, int], ...] = PAGE_BUCKETS

    def find(self, h: int, w: int) -> Tuple[int, int]:
        """Smallest bucket that fits (h, w); largest bucket if none fits
        (caller should downscale first — see ``fit_with_scale``)."""
        for bh, bw in self.shapes:
            if h <= bh and w <= bw:
                return bh, bw
        return self.shapes[-1]

    def fit_with_scale(self, h: int, w: int) -> Tuple[Tuple[int, int], float]:
        """Bucket plus the scale (<=1) needed to make the page fit it."""
        bh, bw = self.find(h, w)
        scale = min(bh / h, bw / w, 1.0)
        return (bh, bw), scale


def bucket_for(h: int, w: int, shapes: Sequence[Tuple[int, int]] = PAGE_BUCKETS):
    return BucketSpec(tuple(shapes)).find(h, w)


def width_bucket(aspect_w: int, buckets: Sequence[int] = CROP_WIDTH_BUCKETS) -> int:
    """Smallest width bucket >= the aspect-preserved width."""
    for b in buckets:
        if aspect_w <= b:
            return b
    return buckets[-1]


def pad_to(img: np.ndarray, h: int, w: int, value: int = 255) -> np.ndarray:
    """Pad a [H, W, C] (or [H, W]) numpy image bottom/right to (h, w)."""
    ph = h - img.shape[0]
    pw = w - img.shape[1]
    if ph < 0 or pw < 0:
        raise ValueError(
            f"image {img.shape[:2]} larger than target ({h}, {w}); scale first"
        )
    pads = [(0, ph), (0, pw)] + [(0, 0)] * (img.ndim - 2)
    return np.pad(img, pads, constant_values=value)


def group_by_bucket(
    widths: Sequence[int], buckets: Sequence[int] = CROP_WIDTH_BUCKETS
) -> Dict[int, List[int]]:
    """Host-side: group crop indices by width bucket so each bucket runs as
    one fixed-shape device batch."""
    groups: Dict[int, List[int]] = {}
    for i, w in enumerate(widths):
        groups.setdefault(width_bucket(int(w), buckets), []).append(i)
    return groups


def pad_batch(n: int, batch_sizes: Sequence[int] = (8, 16, 32, 64, 128, 256)) -> int:
    """Pad a batch count up to the nearest compiled batch size."""
    for b in batch_sizes:
        if n <= b:
            return b
    return ((n + batch_sizes[-1] - 1) // batch_sizes[-1]) * batch_sizes[-1]
