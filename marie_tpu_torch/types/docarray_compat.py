"""docarray-v2 protobuf payload conversion (port of
``marie_tpu/types/docarray_compat.py``) on the dict form of
:mod:`marie_tpu_torch.proto.messages`.

Each ``docarray.DocProto`` is a ``map<string, NodeProto>``; a
``NodeProto`` is a tagged union (text / integer / float / boolean / blob /
ndarray / doc / doc_array / list / set / tuple / dict) beside a type tag.
The conversion makes the JAX module's choices, so the same values give
the same bytes: ``None`` leaves an empty node (and a ``None`` field of a
document is left out), ints outside int32 ride as doubles, a dict with an
``"id"`` key is a nested document, a list of such dicts a doc array, and
an empty dict or list sets only the type tag.
"""

from typing import Any, Dict

import numpy as np

_INT32_MIN, _INT32_MAX = -(2**31), 2**31 - 1
_SCALARS = ("text", "integer", "float", "boolean", "blob")


def node_to_py(node: Dict[str, Any]) -> Any:
    """NodeProto -> python value."""
    for which in _SCALARS:
        if which in node:
            return node[which]
    if "ndarray" in node:
        dense = node["ndarray"].get("dense", {})
        arr = np.frombuffer(dense.get("buffer", b""), dtype=np.dtype(dense.get("dtype", "")))
        shape = dense.get("shape")
        return arr.reshape(tuple(shape)) if shape else arr
    if "doc" in node:
        return docproto_to_dict(node["doc"])
    if "doc_array" in node:
        return [docproto_to_dict(d) for d in node["doc_array"].get("docs", [])]
    for which in ("list", "tuple", "set"):
        if which in node:
            return [node_to_py(n) for n in node[which].get("data", [])]
    if "dict" in node:
        return {k: node_to_py(v) for k, v in node["dict"].get("data", {}).items()}
    return None


def py_to_node(value: Any) -> Dict[str, Any]:
    """``value`` as a NodeProto."""
    if value is None:
        return {}  # empty node
    if isinstance(value, bool):  # before int: bool is an int subclass
        return {"boolean": value, "type": "boolean"}
    if isinstance(value, str):
        return {"text": value, "type": "text"}
    if isinstance(value, (bytes, bytearray)):
        return {"blob": bytes(value), "type": "bytes"}
    if isinstance(value, (int, np.integer)):
        v = int(value)
        if _INT32_MIN <= v <= _INT32_MAX:
            return {"integer": v, "type": "integer"}
        return {"float": float(v), "type": "float"}  # NodeProto.integer is int32
    if isinstance(value, (float, np.floating)):
        return {"float": float(value), "type": "float"}
    if isinstance(value, np.ndarray):
        dense = {"buffer": np.ascontiguousarray(value).tobytes(), "shape": list(value.shape),
                 "dtype": str(value.dtype)}
        return {"ndarray": {"dense": dense}, "type": "ndarray"}
    if isinstance(value, dict):
        if _looks_like_doc(value):
            doc = dict_to_docproto(value)
            node = {"doc": doc} if _doc_touched(value) else {}
            node["type"] = "doc"
            return node
        node = {"dict": {"data": {str(k): py_to_node(v) for k, v in value.items()}}} \
            if value else {}
        node["type"] = "dict"
        return node
    if isinstance(value, (list, tuple, set, frozenset)):
        items = list(value)
        if items and all(isinstance(i, dict) and _looks_like_doc(i) for i in items):
            return {"doc_array": {"docs": [dict_to_docproto(i) for i in items]},
                    "type": "docarray"}
        kind = ("list" if isinstance(value, list) else "tuple" if isinstance(value, tuple)
                else "set")
        node = {kind: {"data": [py_to_node(i) for i in items]}} if items else {}
        node["type"] = kind
        return node
    raise ValueError(f"cannot encode {type(value).__name__} into NodeProto")


def _looks_like_doc(d: Dict[str, Any]) -> bool:
    """Nested docs are dicts with an 'id' key (docarray sub-documents)."""
    return "id" in d


def _doc_touched(d: Dict[str, Any]) -> bool:
    """Whether the JAX conversion creates the nested DocProto: it does at
    the first field that is not None."""
    return any(v is not None for v in d.values())


def docproto_to_dict(dp: Dict[str, Any]) -> Dict[str, Any]:
    return {k: node_to_py(v) for k, v in dp.get("data", {}).items()}


def dict_to_docproto(d: Dict[str, Any]) -> Dict[str, Any]:
    return {"data": {str(k): py_to_node(v) for k, v in d.items() if v is not None}}
