"""Asset archive helpers (copy of ``merge_zip`` of
``marie_tpu/utils/archive.py``, upstream marie's ``zip_ops.merge_zip``)."""

import os
import zipfile
from typing import List


def merge_zip(src_dir: str, zip_path: str) -> List[str]:
    """Zip every file under ``src_dir`` (flat, sorted) into ``zip_path``;
    returns the archived names.  A missing or empty dir yields an empty
    archive rather than an error."""
    names: List[str] = []
    with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_DEFLATED) as zf:
        if os.path.isdir(src_dir):
            for base, _, files in os.walk(src_dir):
                for f in sorted(files):
                    full = os.path.join(base, f)
                    arcname = os.path.relpath(full, src_dir)
                    zf.write(full, arcname)
                    names.append(arcname)
    return names
