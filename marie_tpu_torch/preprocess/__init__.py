from marie_tpu_torch.preprocess.buckets import (
    CROP_WIDTH_BUCKETS,
    PAGE_BUCKETS,
    BucketSpec,
    bucket_for,
    group_by_bucket,
    pad_to,
)
from marie_tpu_torch.preprocess.ops import (
    crop_resize,
    normalize_page,
    otsu_binarize,
    prepare_page,
    to_grayscale,
)

__all__ = [
    "BucketSpec",
    "PAGE_BUCKETS",
    "CROP_WIDTH_BUCKETS",
    "bucket_for",
    "group_by_bucket",
    "pad_to",
    "crop_resize",
    "normalize_page",
    "otsu_binarize",
    "to_grayscale",
    "prepare_page",
]
