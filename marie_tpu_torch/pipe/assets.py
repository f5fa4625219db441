"""Pipeline asset lifecycle: burst, store and restore document assets
(port of ``marie_tpu/pipe/assets.py``; the frame writers go through
:mod:`marie_tpu_torch.utils.image_io` instead of PIL).

Every pipeline run is rooted in a checksum-keyed asset directory; stage
outputs live in named subdirectories (``clean``, ``results``, ``pdf``
…), and the tree is mirrored to primary storage keyed by ``(ref_id,
ref_type)``, so a re-run of the same document can restore the prior
assets and skip work whose outputs already exist (the classification
pipeline's OCR cache, ``results/ocr.json``).
"""

import os
from functools import partial
from typing import List, Optional, Tuple

import numpy as np

from marie_tpu_torch.helper import ensure_exists
from marie_tpu_torch.logging_core import MarieLogger
from marie_tpu_torch.storage.manager import StorageManager

logger = MarieLogger("pipe.assets")


def split_filename(ref_id: str) -> Tuple[str, str, str]:
    """``"sample.tif"`` → ``("sample.tif", "sample", "tif")``."""
    filename = os.path.basename(ref_id)
    if not filename:  # degenerate ids like "/" or "dir/" — stay total
        filename = "doc"
    prefix, _, suffix = filename.rpartition(".")
    if not prefix:  # no dot — the whole name is the prefix
        prefix, suffix = filename, ""
    return filename, prefix, suffix


def filename_supplier_page(
    filename: str, prefix: str, suffix: str, page_index: int
) -> str:
    """Numbered per-page asset name (``sample_00001.tif``)."""
    ext = suffix or "tif"
    return f"{prefix}_{page_index:05d}.{ext}"


def get_file_count(directory: str) -> int:
    if not os.path.isdir(directory):
        return 0
    return sum(1 for n in os.listdir(directory)
               if os.path.isfile(os.path.join(directory, n)))


def s3_asset_path(
    ref_id: str,
    ref_type: str,
    include_prefix: bool = False,
    include_filename: bool = False,
) -> str:
    """Canonical storage location for a document's assets —
    ``s3://{bucket}/{ref_type}/{prefix}`` with lowercased, traversal-safe
    components (upstream marie's ``s3_asset_path``)."""
    assert not (include_prefix and include_filename)
    filename, prefix, _ = split_filename(ref_id)
    ref_type = ref_type.replace("/", "_").replace("..", "_").lower()
    safe_prefix = prefix.replace("/", "_").replace("..", "_")
    bucket = os.environ.get("MARIE_S3_BUCKET", "marie")
    path = f"s3://{bucket}/{ref_type}/{safe_prefix.lower()}"
    if include_prefix:
        path = f"{path}/{safe_prefix}"
    if include_filename:
        path = f"{path}/{filename}"
    return path


def save_frame(frame: np.ndarray, path: str) -> None:
    """Save one page frame: a PackBits TIFF for ``.tif``/``.tiff`` paths
    (bool frames 1-bit; the JAX package writes those as CCITT G4, which
    :mod:`~marie_tpu_torch.utils.image_io` does not encode), a PNG of a
    uint8 gray or RGB frame otherwise."""
    from marie_tpu_torch.utils.image_io import write_png, write_tiff

    frame = np.asarray(frame)
    if path.lower().endswith((".tif", ".tiff")):
        write_tiff(path, [frame])
    else:
        write_png(path, frame)


def burst_frames(
    ref_id: str,
    frames: List[np.ndarray],
    root_asset_dir: str,
    force: bool = False,
) -> str:
    """Burst page frames to numbered files under ``burst/``; a no-op when
    the directory already holds one file per page (upstream marie's
    ``burst_frames``)."""
    output_dir = ensure_exists(os.path.join(root_asset_dir, "burst"))
    filename, prefix, suffix = split_filename(ref_id)
    namer = partial(filename_supplier_page, filename, prefix, suffix or "tif")
    if not force and get_file_count(output_dir) == len(frames):
        logger.debug(f"burst skipped (count match) for {ref_id}")
        return output_dir
    for i, frame in enumerate(frames):
        save_frame(frame, os.path.join(output_dir, namer(i)))
    return output_dir


def restore_assets(
    ref_id: str,
    ref_type: str,
    root_asset_dir: str,
    full_restore: bool = False,
    overwrite: bool = False,
) -> Optional[str]:
    """Restore prior-run assets from primary storage into the local asset
    dir.  Partial restore pulls only the subtrees the extract pipeline
    can reuse (``clean``, ``results``, ``pdf``), as upstream marie's
    ``restore_assets``.  Best-effort: returns the
    remote base, or None when storage is not connected."""
    remote_base = s3_asset_path(ref_id, ref_type)
    if not StorageManager.ensure_connection("s3://", silence_exceptions=True):
        logger.warning("restore_assets: storage not connected; skipping")
        return None
    try:
        if full_restore:
            StorageManager.copy_remote(
                remote_base, root_asset_dir, match_wildcard="*",
                overwrite=overwrite,
            )
        else:
            for sub in ("clean", "results", "pdf"):
                StorageManager.copy_remote(
                    remote_base, root_asset_dir,
                    match_wildcard=f"{sub}/*", overwrite=overwrite,
                )
    except Exception as ex:  # noqa: BLE001 — restore must not fail the job
        logger.error(f"restore_assets failed: {ex!r}")
        return None
    return remote_base


def store_assets(
    ref_id: str,
    ref_type: str,
    root_asset_dir: str,
    match_wildcard: str = "*",
) -> List[str]:
    """Mirror the local asset dir to primary storage (upstream marie's
    ``store_assets``).  Best-effort."""
    remote_base = s3_asset_path(ref_id, ref_type)
    if not StorageManager.ensure_connection("s3://", silence_exceptions=True):
        logger.warning("store_assets: storage not connected; skipping")
        return []
    try:
        return StorageManager.copy_dir(
            root_asset_dir, remote_base,
            relative_to_dir=root_asset_dir, match_wildcard=match_wildcard,
        )
    except Exception as ex:  # noqa: BLE001
        logger.error(f"store_assets failed: {ex!r}")
        return []
