"""Local-filesystem path handler (copy of ``marie_tpu/storage/native_handler.py``)."""

import os
import shutil
from typing import List

from marie_tpu_torch.excepts import StorageError
from marie_tpu_torch.storage.manager import PathHandler


class NativePathHandler(PathHandler):
    def get_supported_prefixes(self) -> List[str]:
        return ["file://", "/"]

    @staticmethod
    def _local(path: str) -> str:
        return path[len("file://") :] if path.startswith("file://") else path

    def exists(self, path: str) -> bool:
        return os.path.exists(self._local(path))

    def read_bytes(self, path: str) -> bytes:
        p = self._local(path)
        if not os.path.exists(p):
            raise StorageError(f"not found: {path}")
        with open(p, "rb") as fp:
            return fp.read()

    def write_bytes(self, path: str, data: bytes) -> None:
        p = self._local(path)
        os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
        with open(p, "wb") as fp:
            fp.write(data)

    def list(self, path: str) -> List[str]:
        p = self._local(path)
        if not os.path.isdir(p):
            return []
        out = []
        for base, _, files in os.walk(p):
            out.extend(os.path.join(base, f) for f in files)
        return sorted(out)

    def ensure_dir(self, path: str) -> None:
        os.makedirs(self._local(path), exist_ok=True)

    def delete(self, path: str) -> None:
        p = self._local(path)
        if os.path.isdir(p):
            shutil.rmtree(p)
        elif os.path.exists(p):
            os.remove(p)
