"""Host helpers (copy of the part of ``marie_tpu/helper.py`` the pipelines
call)."""

import os


def ensure_exists(path: str) -> str:
    """``path`` as a directory, made with its parents when missing."""
    os.makedirs(path, exist_ok=True)
    return path
