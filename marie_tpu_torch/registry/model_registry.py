"""ModelRegistry: a model name or URI to a local path (port of
``marie_tpu/registry/model_registry.py``).

``zoo://name`` resolves against local zoo directories: the port's
``torch_zoo/`` first, then the JAX package's defaults (``/mnt/models``,
``~/.marie/model_zoo``, ``./model_zoo``).  A name is a directory there (an
orbax tree, as JAX resolves it) or, in the port, a ``<name>.npz`` tree
(``registry/checkpoints.py``).  ``hf://repo`` resolves only from the local
HuggingFace cache and downloads nothing.  A plain path that is a directory
passes through.
"""

import os
from abc import ABC, abstractmethod
from typing import Dict, List, Optional

from marie_tpu_torch.excepts import ModelRegistryError
from marie_tpu_torch.logging_core import MarieLogger
from marie_tpu_torch.registry.zoo import ZOO_DIR

_DEFAULT_ZOO_DIRS = [ZOO_DIR, "/mnt/models", os.path.expanduser("~/.marie/model_zoo"),
                     "./model_zoo"]


class ModelRegistryHandler(ABC):
    @abstractmethod
    def get_supported_prefixes(self) -> List[str]: ...

    @abstractmethod
    def resolve(self, name: str, **kwargs) -> str:
        """Return a local path for the model."""

    @abstractmethod
    def exists(self, name: str) -> bool: ...


class NativeModelRegistryHandler(ModelRegistryHandler):
    """``zoo://``: local zoo directories, each holding a model as a
    directory or as a ``<name>.npz`` tree."""

    def __init__(self, zoo_dirs: Optional[List[str]] = None):
        self.zoo_dirs = zoo_dirs or list(_DEFAULT_ZOO_DIRS)

    def get_supported_prefixes(self) -> List[str]:
        return ["zoo://"]

    def _candidates(self, name: str) -> List[str]:
        name = name[len("zoo://"):] if name.startswith("zoo://") else name
        return [p for d in self.zoo_dirs
                for p in (os.path.join(d, name), os.path.join(d, f"{name}.npz"))]

    @staticmethod
    def _found(path: str) -> bool:
        return os.path.isdir(path) if not path.endswith(".npz") else os.path.isfile(path)

    def exists(self, name: str) -> bool:
        return any(self._found(p) for p in self._candidates(name))

    def resolve(self, name: str, **kwargs) -> str:
        for p in self._candidates(name):
            if self._found(p):
                return p
        raise ModelRegistryError(f"model {name!r} not found in zoo dirs {self.zoo_dirs}")


class HuggingFaceModelRegistryHandler(ModelRegistryHandler):
    """``hf://repo-id``: from the local HuggingFace cache only (the newest
    snapshot); nothing is downloaded."""

    def get_supported_prefixes(self) -> List[str]:
        return ["hf://"]

    def _cache_path(self, name: str) -> Optional[str]:
        repo = name[len("hf://"):]
        base = os.path.expanduser(os.environ.get("HF_HOME", "~/.cache/huggingface"))
        snap = os.path.join(base, "hub", f"models--{repo.replace('/', '--')}")
        snaps = os.path.join(snap, "snapshots")
        if os.path.isdir(snaps):
            subdirs = sorted(os.listdir(snaps))
            if subdirs:
                return os.path.join(snaps, subdirs[-1])
        return None

    def exists(self, name: str) -> bool:
        return self._cache_path(name) is not None

    def resolve(self, name: str, **kwargs) -> str:
        p = self._cache_path(name)
        if p is None:
            raise ModelRegistryError(
                f"{name!r} not in the local HuggingFace cache and downloads "
                "are unavailable in this environment"
            )
        return p


class ModelRegistry:
    _handlers: Dict[str, ModelRegistryHandler] = {}
    logger = MarieLogger("ModelRegistry")

    @classmethod
    def register_handler(cls, handler: ModelRegistryHandler) -> None:
        for prefix in handler.get_supported_prefixes():
            cls._handlers[prefix] = handler

    @classmethod
    def _ensure_defaults(cls) -> None:
        if not cls._handlers:
            cls.register_handler(NativeModelRegistryHandler())
            cls.register_handler(HuggingFaceModelRegistryHandler())

    @classmethod
    def get(cls, name: str, **kwargs) -> str:
        """Resolve a model name or URI to a local path."""
        cls._ensure_defaults()
        for prefix, handler in cls._handlers.items():
            if name.startswith(prefix):
                return handler.resolve(name, **kwargs)
        if os.path.isdir(name):
            return name
        raise ModelRegistryError(f"cannot resolve model {name!r}")

    @classmethod
    def exists(cls, name: str) -> bool:
        cls._ensure_defaults()
        for prefix, handler in cls._handlers.items():
            if name.startswith(prefix):
                return handler.exists(name)
        return os.path.isdir(name)
