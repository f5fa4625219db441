"""JAML, the YAML object system (port of ``marie_tpu/jaml/__init__.py``) on
the standard-library reader and writer of :mod:`.parser` (PyYAML is not
on the card's machine).

* ``jtype: ClassName`` builds a registered class, with its constructor
  keywords under ``with:`` and metadata under ``metas:``.  A dotted
  ``jtype`` under the JAX package's name resolves to the same path under
  ``marie_tpu_torch`` (``config/service/*.yml`` name the JAX executors);
  the JAX package is never imported, not even to resolve a name.
* ``${{ ENV.X }}`` substitutes an environment variable, ``${{ CONTEXT.x }}``
  (or a bare ``${{ x }}``) an entry of the caller's context; a trailing
  ``| default`` is the fallback: ``${{ ENV.PORT | 8080 }}``.  A whole-value
  substitution is read back as YAML (``"8080"`` -> 8080).
* :class:`JAMLCompatible` registers every subclass by class name so that
  YAML can name it; ``load_config`` / ``save_config`` round-trip it.
"""

import importlib
import os
import re
from abc import ABCMeta
from typing import Any, Dict, Optional, TextIO, Union

from marie_tpu_torch.excepts import BadConfigSource
from marie_tpu_torch.jaml import parser

__all__ = ["JAML", "JAMLCompatible", "JAMLCompatibleType", "resolve_jtype_path"]

_VAR_RE = re.compile(r"\$\{\{\s*([^}]+?)\s*\}\}")
#: the package whose dotted jtypes map onto this one's
_REFERENCE_PKG = "marie_tpu"
_PORT_PKG = "marie_tpu_torch"


class _Registry:
    _classes: Dict[str, type] = {}

    @classmethod
    def register(cls, klass: type) -> None:
        cls._classes[klass.__name__] = klass

    @classmethod
    def get(cls, name: str) -> Optional[type]:
        return cls._classes.get(name)


class JAMLCompatibleType(ABCMeta):
    """Metaclass that registers every subclass for YAML construction (an
    ABCMeta, so JAMLCompatible classes can be ABCs too)."""

    def __new__(mcs, name, bases, namespace):
        klass = super().__new__(mcs, name, bases, namespace)
        _Registry.register(klass)
        return klass


class JAMLCompatible(metaclass=JAMLCompatibleType):
    """Base class of anything constructible from YAML through ``jtype``."""

    @classmethod
    def load_config(cls, source: Union[str, TextIO, Dict],
                    context: Optional[Dict[str, Any]] = None, substitute: bool = True,
                    runtime_args: Optional[Dict[str, Any]] = None, **extra_kwargs):
        cfg = JAML.load_config(source, context=context, substitute=substitute)
        if not isinstance(cfg, dict):
            raise BadConfigSource(f"expected a mapping at top level, got {type(cfg)}")
        obj = JAML.construct(cfg, expected_cls=cls, extra_kwargs=extra_kwargs)
        if runtime_args and hasattr(obj, "runtime_args"):
            for k, v in runtime_args.items():
                setattr(obj.runtime_args, k, v)
        return obj

    def save_config(self, path: str) -> None:
        with open(path, "w") as fp:
            parser.dump(JAML.deconstruct(self), fp)


class JAML:
    """Static facade: load, dump, substitute, construct."""

    @staticmethod
    def load(stream) -> Any:
        return parser.load(stream)

    @staticmethod
    def dump(data, stream=None) -> Optional[str]:
        return parser.dump(data, stream)

    @staticmethod
    def load_config(source: Union[str, TextIO, Dict],
                    context: Optional[Dict[str, Any]] = None, substitute: bool = True) -> Any:
        """A config from a dict, a file object, a path or inline YAML (a
        string with a newline or a colon), substituted unless told not."""
        if isinstance(source, dict):
            data = source
        else:
            text = None
            if hasattr(source, "read"):
                text = source.read()
            elif isinstance(source, str):
                if os.path.exists(source):
                    with open(source) as fp:
                        text = fp.read()
                elif "\n" in source or ":" in source:
                    text = source
                else:
                    raise BadConfigSource(f"cannot find config file: {source}")
            if text is None:
                raise BadConfigSource(f"unsupported config source {type(source)}")
            data = parser.load(text)
        if substitute:
            data = JAML.expand_dict(data, context=context)
        return data

    @staticmethod
    def expand_dict(data: Any, context: Optional[Dict[str, Any]] = None) -> Any:
        """Substitute every ``${{ ... }}`` expression, recursively."""
        context = context or {}

        def _resolve(expr: str) -> Any:
            expr = expr.strip()
            default: Any = None
            has_default = False
            if "|" in expr:
                expr, _, default = expr.partition("|")
                expr, default = expr.strip(), default.strip()
                has_default = True
            if expr.upper().startswith("ENV."):
                key = expr[4:]
                if key in os.environ:
                    return os.environ[key]
                return default if has_default else None
            key = expr[8:] if expr.upper().startswith("CONTEXT.") else expr
            if key in context:
                return context[key]
            return default if has_default else None

        def _sub(val: Any) -> Any:
            if isinstance(val, str):
                m = _VAR_RE.fullmatch(val.strip())
                if m:  # whole-value substitution keeps the native type
                    resolved = _resolve(m.group(1))
                    return _parse_scalar(resolved) if resolved is not None else None
                return _VAR_RE.sub(lambda mm: str(_resolve(mm.group(1)) or ""), val)
            if isinstance(val, dict):
                return {k: _sub(v) for k, v in val.items()}
            if isinstance(val, list):
                return [_sub(v) for v in val]
            return val

        return _sub(data)

    @staticmethod
    def construct(cfg: Dict[str, Any], expected_cls: Optional[type] = None,
                  extra_kwargs: Optional[Dict[str, Any]] = None) -> Any:
        """An object from a ``jtype`` mapping."""
        cfg = dict(cfg)
        jtype = cfg.pop("jtype", None)
        if jtype is None:
            if expected_cls is None:
                return cfg
            klass: Optional[type] = expected_cls
        else:
            klass = resolve_jtype(jtype)
            if klass is None:
                raise BadConfigSource(f"unknown jtype: {jtype!r}")
            if (expected_cls is not None and expected_cls is not JAMLCompatible
                    and not issubclass(klass, expected_cls)):
                raise BadConfigSource(f"jtype {jtype} is not a subclass of "
                                      f"{expected_cls.__name__}")
        with_kwargs = dict(cfg.pop("with", None) or {})
        metas = cfg.pop("metas", None) or {}
        for k, v in list(with_kwargs.items()):  # nested jtype objects in `with`
            if isinstance(v, dict) and "jtype" in v:
                with_kwargs[k] = JAML.construct(v)
        with_kwargs.update(extra_kwargs or {})
        if hasattr(klass, "_from_yaml_config"):
            obj = klass._from_yaml_config(with_kwargs, metas=metas, raw=cfg)
        else:
            obj = klass(**with_kwargs)
        if metas and hasattr(obj, "metas"):
            for k, v in metas.items():
                try:
                    setattr(obj.metas, k, v)
                except Exception:  # noqa: BLE001 — a frozen metas namespace
                    pass
        return obj

    @staticmethod
    def deconstruct(obj: Any) -> Dict[str, Any]:
        """Best-effort round trip: an object as a jtype mapping."""
        if hasattr(obj, "_to_yaml_config"):
            return obj._to_yaml_config()
        cfg: Dict[str, Any] = {"jtype": type(obj).__name__}
        init_kwargs = getattr(obj, "_init_kwargs_", None)
        if init_kwargs:
            cfg["with"] = dict(init_kwargs)
        return cfg

    @staticmethod
    def registered_classes() -> Dict[str, type]:
        return dict(_Registry._classes)


def _parse_scalar(v: Any) -> Any:
    if not isinstance(v, str):
        return v
    try:
        return parser.load(v)
    except Exception:  # noqa: BLE001 — not YAML: the text itself
        return v


def resolve_jtype_path(path: str) -> str:
    """A dotted path under the JAX package's name -> the same path under
    this package's; any other path unchanged."""
    if path == _REFERENCE_PKG or path.startswith(_REFERENCE_PKG + "."):
        return _PORT_PKG + path[len(_REFERENCE_PKG):]
    return path


def resolve_jtype(jtype: str) -> Optional[type]:
    """A bare name through the registry, a dotted path by import (the JAX
    package's paths mapped onto this package's); None when unknown."""
    klass = _Registry.get(jtype)
    if klass is not None:
        return klass
    if "." not in jtype:
        return None
    mod_name, _, cls_name = resolve_jtype_path(jtype).rpartition(".")
    try:
        mod = importlib.import_module(mod_name)
    except ImportError:
        return None
    return getattr(mod, cls_name, None)
