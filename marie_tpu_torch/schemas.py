"""The YAML JSON-schema export (port of ``marie_tpu/schemas.py``): a
draft-07 schema of the Flow, Deployment and Executor YAML, made by reading
the classes' constructor signatures (the ``export --kind schema`` CLI)."""

import inspect
import typing
from typing import Any, Dict

from marie_tpu_torch import __version__


_PY_TO_JSON = {
    int: {"type": "integer"},
    float: {"type": "number"},
    bool: {"type": "boolean"},
    str: {"type": "string"},
    dict: {"type": "object"},
    list: {"type": "array"},
}


def _annotation_schema(ann: Any) -> Dict[str, Any]:
    """Best-effort JSON-schema fragment for a type annotation."""
    if ann is inspect.Parameter.empty or ann is Any:
        return {}
    origin = typing.get_origin(ann)
    if origin is typing.Union:
        args = [a for a in typing.get_args(ann) if a is not type(None)]
        subs = [s for s in (_annotation_schema(a) for a in args) if s]
        if not subs:
            return {}
        return subs[0] if len(subs) == 1 else {"oneOf": subs}
    if origin in (list, typing.Sequence, tuple):
        return {"type": "array"}
    if origin is dict:
        return {"type": "object"}
    return dict(_PY_TO_JSON.get(ann, {}))


def _class_schema(cls: type, title: str) -> Dict[str, Any]:
    props: Dict[str, Any] = {
        "jtype": {"type": "string", "const": cls.__name__},
    }
    sig = inspect.signature(cls.__init__)
    with_props: Dict[str, Any] = {}
    for name, p in sig.parameters.items():
        if name in ("self",) or p.kind in (
            inspect.Parameter.VAR_POSITIONAL,
            inspect.Parameter.VAR_KEYWORD,
        ):
            continue
        frag = _annotation_schema(p.annotation)
        if p.default is not inspect.Parameter.empty and p.default is not None:
            frag = dict(frag)
            try:  # defaults must be JSON-encodable to land in the schema
                import json

                json.dumps(p.default)
                frag["default"] = p.default
            except TypeError:
                pass
        with_props[name] = frag
    props["with"] = {"type": "object", "properties": with_props}
    doc = inspect.getdoc(cls) or ""
    return {
        "type": "object",
        "title": title,
        "description": doc.split("\n", 1)[0],
        "properties": props,
    }


def get_full_schema() -> Dict[str, Any]:
    """Full draft-07 schema of marie-tpu YAML objects."""
    from marie_tpu_torch.orchestrate.deployments import Deployment
    from marie_tpu_torch.orchestrate.flow import Flow
    from marie_tpu_torch.serve.executors import BaseExecutor

    flow_schema = _class_schema(Flow, "Marie::Flow")
    # a Flow YAML also carries `executors:` (list of Deployment blocks)
    flow_schema["properties"]["executors"] = {
        "type": "array",
        "items": {"$ref": "#/definitions/Marie::Deployment"},
    }
    definitions = {
        "Marie::Flow": flow_schema,
        "Marie::Deployment": _class_schema(Deployment, "Marie::Deployment"),
        "Marie::Executor": _class_schema(BaseExecutor, "Marie::Executor"),
    }
    return {
        "$id": f"https://marie-tpu.local/schemas/{__version__}.json",
        "$schema": "http://json-schema.org/draft-07/schema#",
        "description": (
            "The YAML schema of marie-tpu objects (Flow, Deployment, "
            "Executor)."
        ),
        "type": "object",
        "oneOf": [{"$ref": f"#/definitions/{k}"} for k in definitions],
        "definitions": definitions,
    }
