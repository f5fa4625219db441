"""Host helpers (copy of the parts of ``marie_tpu/helper.py`` the port
calls; :func:`get_full_version` reports torch and CUDA where the JAX one
reports JAX)."""

import asyncio
import os
import random
import socket
import threading
from typing import Any, List

_RANDOM_PORT_MIN, _RANDOM_PORT_MAX = 49153, 65535
_assigned_ports: set = set()
_port_lock = threading.Lock()


def default_bind_host() -> str:
    """The address servers listen on: loopback unless ``MARIE_BIND_HOST``
    says otherwise (e.g. ``0.0.0.0`` inside a container)."""
    return os.environ.get("MARIE_BIND_HOST", "127.0.0.1")


def random_port() -> int:
    """A free TCP port on the loopback, not handed out earlier in this
    process."""
    with _port_lock:
        for _ in range(200):
            port = random.randint(_RANDOM_PORT_MIN, _RANDOM_PORT_MAX)
            if port in _assigned_ports:
                continue
            with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
                try:
                    s.bind(("127.0.0.1", port))
                except OSError:
                    continue
            _assigned_ports.add(port)
            return port
    raise RuntimeError("no free port found")


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


def run_async(coro):
    """Run a coroutine from sync code, even while a loop runs in this
    thread (it then runs on a thread of its own)."""
    try:
        asyncio.get_running_loop()
    except RuntimeError:
        return asyncio.run(coro)
    result: List[Any] = []
    error: List[BaseException] = []

    def _target():
        try:
            result.append(asyncio.run(coro))
        except BaseException as ex:  # noqa: BLE001 — re-raised in the caller
            error.append(ex)

    t = threading.Thread(target=_target, daemon=True)
    t.start()
    t.join()
    if error:
        raise error[0]
    return result[0]
