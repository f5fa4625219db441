"""Job-message payload extraction (port of ``marie_tpu/api/payload.py``).

A job payload names its document by one of several key shapes:
``data`` / ``srcData`` (base64), ``srcBase64`` (base64, stored raw),
``srcFile`` (a path under the shared directory), ``uri`` / ``srcUrl`` (any
location the :class:`StorageManager` routes).  :func:`extract_payload`
brings each to a checksummed temporary file, :func:`parse_payload_to_frames`
on to page frames, decoded by :mod:`marie_tpu_torch.utils.image_io`
(PIL is not on the card's machine).

The JAX package re-saves a ``data`` payload through PIL to normalise its
container; here a PNG is rewritten by the port's PNG writer (the same
pixels), and the other formats the port reads (baseline JPEG, BMP) are
checked by decoding and kept as sent: a JPEG is not encoded a second time.
A format the port does not read (GIF, WebP, and the variants ROADMAP §3
lists) raises ``ValueError``.
"""

import base64
import hashlib
import io
import os
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from marie_tpu_torch.helper import ensure_exists
from marie_tpu_torch.logging_core import MarieLogger
from marie_tpu_torch.storage.manager import StorageManager

logger = MarieLogger("api.payload")

ALLOWED_TYPES = ("png", "jpeg", "tiff", "bmp", "gif", "webp")

_MAGIC = (
    (b"\x89PNG\r\n\x1a\n", "png"),
    (b"\xff\xd8\xff", "jpeg"),
    (b"II*\x00", "tiff"),
    (b"MM\x00*", "tiff"),
    (b"BM", "bmp"),
    (b"GIF87a", "gif"),
    (b"GIF89a", "gif"),
)


def sniff_file_type(data: bytes) -> Optional[str]:
    """The image type by its magic bytes (None when unknown)."""
    for magic, kind in _MAGIC:
        if data[:len(magic)] == magic:
            return kind
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "webp"
    return None


def base64_to_bytes(raw: str) -> bytes:
    """Base64 with a data-URI prefix and whitespace tolerated."""
    if "," in raw[:64] and raw.lstrip().startswith("data:"):
        raw = raw.split(",", 1)[1]
    return base64.b64decode("".join(raw.split()))


def get_share_directory() -> str:
    return os.environ.get("MARIE_SHARE_DIR",
                          os.path.join(tempfile.gettempdir(), "marie-share"))


def _decoded(message_bytes: bytes) -> List[np.ndarray]:
    """The pages of an image the port reads; ValueError for one it does not."""
    from marie_tpu_torch.utils.image_io import read_image, read_tiff

    try:
        if message_bytes[:4] in (b"II*\x00", b"MM\x00*"):
            return read_tiff(io.BytesIO(message_bytes))
        return [read_image(io.BytesIO(message_bytes))]
    except ValueError:
        raise
    except Exception as ex:  # noqa: BLE001 — a corrupt file is a bad payload
        raise ValueError(f"cannot decode the payload's image: {ex!r}") from ex


def store_temp_file(message_bytes: bytes, queue_id: str, file_type: str,
                    store_raw: bool) -> Tuple[str, str]:
    """Write payload bytes to a digest-named temporary file; returns
    ``(path, sha256 checksum of the input bytes)``.  With ``store_raw`` the
    bytes land as sent; otherwise the image is decoded and a PNG rewritten
    (see the module's notes)."""
    digest = hashlib.sha256(message_bytes).hexdigest()
    out_dir = ensure_exists(os.path.join(tempfile.gettempdir(), "marie", queue_id or "default"))
    path = os.path.join(out_dir, f"{digest}.{file_type}")
    if os.path.exists(path):
        return path, digest
    if store_raw:
        with open(path, "wb") as fp:
            fp.write(message_bytes)
        return path, digest
    pages = _decoded(message_bytes)
    if file_type == "png":
        from marie_tpu_torch.utils.image_io import write_png

        img = pages[0]
        if img.ndim == 3 and img.shape[2] == 4:
            from marie_tpu_torch.utils.image_io import drop_alpha

            img = drop_alpha(img)
        write_png(path, img)
    else:
        with open(path, "wb") as fp:
            fp.write(message_bytes)
    return path, digest


def extract_payload(payload: Dict[str, Any], queue_id: str) -> Tuple[str, str, str]:
    """A job payload's document as a temporary file: ``(tmp_file,
    checksum, file_type)``.  Keys in precedence: ``data`` / ``srcData``,
    ``srcBase64``, ``srcFile`` (confined to the share directory), ``uri`` /
    ``srcUrl``."""
    store_raw = False
    if "data" in payload or "srcData" in payload:
        data = base64_to_bytes(payload.get("data") or payload["srcData"])
    elif "srcBase64" in payload:
        data = base64_to_bytes(payload["srcBase64"])
        store_raw = True
    elif "srcFile" in payload:
        base_dir = get_share_directory()
        path = os.path.abspath(os.path.join(base_dir, payload["srcFile"]))
        if not path.startswith(os.path.abspath(base_dir) + os.sep):
            raise ValueError(f"srcFile escapes the share directory: {path}")
        if not os.path.exists(path):
            raise FileNotFoundError(f"File not found: {payload['srcFile']}")
        with open(path, "rb") as fp:
            data = fp.read()
        store_raw = True
    elif "uri" in payload or "srcUrl" in payload:
        uri = payload.get("uri") or payload["srcUrl"]
        if not StorageManager.can_handle(uri):
            raise ValueError(f"no storage handler for {uri!r}")
        if not StorageManager.exists(uri):
            raise FileNotFoundError(f"remote file does not exist: {uri}")
        data = StorageManager.read(uri)
        store_raw = True
    else:
        raise ValueError("unable to determine datasource in payload")

    if not data:
        raise ValueError("no data read from payload")
    file_type = sniff_file_type(data)
    if file_type not in ALLOWED_TYPES:
        raise ValueError(f"unsupported file type {file_type!r}, expected one of {ALLOWED_TYPES}")
    if file_type == "tiff":
        store_raw = True  # keep every page
    tmp_file, digest = store_temp_file(data, queue_id, file_type, store_raw)
    logger.info(f"File info: {digest} {file_type}, {tmp_file}")
    return tmp_file, digest, file_type


def value_from_payload_or_args(payload: Dict[str, Any], key: str, default: Any = None) -> Any:
    """``key`` of the payload, else of ``payload["args"]``."""
    if key in payload:
        return payload[key]
    args = payload.get("args") or {}
    return args.get(key, default)


def parse_payload_to_frames(payload: Dict[str, Any],
                            queue_id: str = "") -> Tuple[List[np.ndarray], str, str]:
    """Payload -> ``(frames, checksum, file_type)``; ValueError for an
    image the port does not read."""
    from marie_tpu_torch.utils.docs import frames_from_file

    tmp_file, checksum, file_type = extract_payload(payload, queue_id)
    try:
        return frames_from_file(tmp_file), checksum, file_type
    except ValueError:
        raise
    except Exception as ex:  # noqa: BLE001 — an unreadable image is a bad payload
        raise ValueError(f"cannot decode the payload's image: {ex!r}") from ex
