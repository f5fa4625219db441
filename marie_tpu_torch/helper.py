"""Host helpers (copy of the parts of ``marie_tpu/helper.py`` the port
calls; :func:`get_full_version` reports torch and CUDA where the JAX one
reports JAX)."""

import os


def default_bind_host() -> str:
    """The address servers listen on: loopback unless ``MARIE_BIND_HOST``
    says otherwise (e.g. ``0.0.0.0`` inside a container)."""
    return os.environ.get("MARIE_BIND_HOST", "127.0.0.1")


def ensure_exists(path: str) -> str:
    """``path`` as a directory, made with its parents when missing."""
    os.makedirs(path, exist_ok=True)
    return path


def get_full_version() -> dict:
    """Version table for diagnostics: the package, python, the platform,
    torch, the CUDA torch was built for, and the card's name and the count
    of cards (``"unavailable"`` and 0 without one).  Never raises."""
    import platform

    info = {
        "marie_tpu_torch": "unknown",
        "python": platform.python_version(),
        "platform": platform.platform(),
    }
    try:
        import marie_tpu_torch

        info["marie_tpu_torch"] = getattr(marie_tpu_torch, "__version__", "unknown")
    except Exception:  # noqa: BLE001 — diagnostics must never fail
        pass
    try:
        import torch

        info["torch"] = torch.__version__
        info["cuda"] = torch.version.cuda
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        info["device_count"] = count
        info["device"] = torch.cuda.get_device_name(0) if count else "unavailable"
    except Exception:  # noqa: BLE001 — diagnostics must never fail
        info.setdefault("torch", "unavailable")
        info.setdefault("device", "unavailable")
        info.setdefault("device_count", 0)
    return info
