"""StorageManager — URI-routed blob storage facade (copy of
``marie_tpu/storage/manager.py``): ``PathHandler`` implementations
register by URI prefix (``s3://`` …); the manager routes read, write,
copy, exists, list and mkdir to the handler.  The local filesystem
handler (:mod:`marie_tpu_torch.storage.native_handler`) serves the rest;
the JAX package's S3 handler is not ported.
"""

import fnmatch
import os
from abc import ABC, abstractmethod
from typing import Dict, List, Optional

from marie_tpu_torch.excepts import StorageError
from marie_tpu_torch.logging_core import MarieLogger


class PathHandler(ABC):
    @abstractmethod
    def get_supported_prefixes(self) -> List[str]: ...

    @abstractmethod
    def exists(self, path: str) -> bool: ...

    @abstractmethod
    def read_bytes(self, path: str) -> bytes: ...

    @abstractmethod
    def write_bytes(self, path: str, data: bytes) -> None: ...

    @abstractmethod
    def list(self, path: str) -> List[str]: ...

    def ensure_dir(self, path: str) -> None:
        pass

    def delete(self, path: str) -> None:
        raise StorageError(f"delete not supported for {path}")

    def read_to_file(self, path: str, local_path: str) -> str:
        with open(local_path, "wb") as fp:
            fp.write(self.read_bytes(path))
        return local_path

    def write_from_file(self, local_path: str, path: str) -> None:
        with open(local_path, "rb") as fp:
            self.write_bytes(path, fp.read())

    def ping(self) -> bool:
        """Cheap reachability probe; handlers backed by remote services
        override this (e.g. S3 HeadBucket)."""
        return True


class StorageManager:
    """Static facade (as upstream marie calls it: ``StorageManager.read(...)``)."""

    _handlers: Dict[str, PathHandler] = {}
    _native: Optional[PathHandler] = None
    logger = MarieLogger("StorageManager")

    @classmethod
    def register_handler(cls, handler: PathHandler, native: bool = False) -> None:
        for prefix in handler.get_supported_prefixes():
            cls._handlers[prefix] = handler
        if native:
            cls._native = handler

    @classmethod
    def _handler_for(cls, path: str) -> PathHandler:
        for prefix, handler in sorted(
            cls._handlers.items(), key=lambda kv: -len(kv[0])
        ):
            if path.startswith(prefix):
                return handler
        if cls._native is None:
            from marie_tpu_torch.storage.native_handler import NativePathHandler

            cls._native = NativePathHandler()
        return cls._native

    # --- facade ---------------------------------------------------------
    @classmethod
    def exists(cls, path: str) -> bool:
        return cls._handler_for(path).exists(path)

    @classmethod
    def read(cls, path: str) -> bytes:
        return cls._handler_for(path).read_bytes(path)

    @classmethod
    def write(cls, path: str, data: bytes) -> None:
        cls._handler_for(path).write_bytes(path, data)

    @classmethod
    def list(cls, path: str) -> List[str]:
        return cls._handler_for(path).list(path)

    @classmethod
    def mkdir(cls, path: str) -> None:
        cls._handler_for(path).ensure_dir(path)

    @classmethod
    def read_to_file(cls, path: str, local_path: str) -> str:
        return cls._handler_for(path).read_to_file(path, local_path)

    @classmethod
    def write_from_file(cls, local_path: str, path: str) -> None:
        cls._handler_for(path).write_from_file(local_path, path)

    @classmethod
    def copy(cls, src: str, dst: str) -> None:
        cls.write(dst, cls.read(src))

    @classmethod
    def ensure_connection(
        cls, prefix: str, silence_exceptions: bool = False
    ) -> bool:
        """True iff a handler is registered for ``prefix`` and reachable
        (upstream marie's ``StorageManager.ensure_connection``)."""
        try:
            handler = cls._handlers.get(prefix)
            if handler is None:
                for p, h in cls._handlers.items():
                    if prefix.startswith(p):
                        handler = h
                        break
            if handler is None:
                raise StorageError(f"no storage handler for prefix {prefix!r}")
            if not handler.ping():
                raise StorageError(f"storage backend unreachable: {prefix!r}")
            return True
        except Exception:
            if silence_exceptions:
                return False
            raise

    @classmethod
    def copy_dir(
        cls,
        local_dir: str,
        remote_base: str,
        relative_to_dir: Optional[str] = None,
        match_wildcard: str = "*",
    ) -> List[str]:
        """Upload every file under ``local_dir`` whose relative path
        matches ``match_wildcard`` to ``remote_base`` (upstream marie's
        ``StorageManager.copy_dir`` as ``store_assets`` uses it)."""
        rel_root = relative_to_dir or local_dir
        stored: List[str] = []
        for base, _, files in os.walk(local_dir):
            for name in sorted(files):
                src = os.path.join(base, name)
                rel = os.path.relpath(src, rel_root)
                if not (
                    fnmatch.fnmatch(rel, match_wildcard)
                    or fnmatch.fnmatch("/" + rel, match_wildcard)
                    or fnmatch.fnmatch(name, match_wildcard)
                ):
                    continue
                dst = remote_base.rstrip("/") + "/" + rel.replace(os.sep, "/")
                cls.write_from_file(src, dst)
                stored.append(dst)
        return stored

    @classmethod
    def copy_remote(
        cls,
        remote_base: str,
        local_dir: str,
        match_wildcard: str = "*",
        overwrite: bool = False,
    ) -> List[str]:
        """Download every object under ``remote_base`` whose path matches
        ``match_wildcard`` into ``local_dir``, preserving relative layout
        (upstream marie's ``restore_assets`` path)."""
        base = remote_base.rstrip("/")
        restored: List[str] = []
        for remote in cls.list(base):
            rel = remote[len(base):].lstrip("/") if remote.startswith(base) else remote
            if not rel:
                continue
            if not (
                fnmatch.fnmatch(remote, match_wildcard)
                or fnmatch.fnmatch(rel, match_wildcard)
                or fnmatch.fnmatch("/" + rel, match_wildcard)
            ):
                continue
            dst = os.path.join(local_dir, *rel.split("/"))
            if os.path.exists(dst) and not overwrite:
                restored.append(dst)
                continue
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            cls.read_to_file(remote, dst)
            restored.append(dst)
        return restored

    @classmethod
    def can_handle(cls, path: str) -> bool:
        try:
            cls._handler_for(path)
            return True
        except StorageError:
            return False
