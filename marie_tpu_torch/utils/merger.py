"""Recursive dict union (port of ``marie_tpu/utils/merger.py``):
``deep_merge_dicts`` recursively unions nested dicts with ``from_dict``
winning scalar conflicts; ``merge_dicts`` is the shallow latest-wins
variant.  Used for layering YAML config fragments and per-request feature
overrides."""

import copy
from typing import Any, Dict, Mapping


def deep_merge_dicts(onto: Mapping, from_dict: Mapping) -> Dict:
    """Union of two dicts; dict-valued keys present in both merge
    recursively, anything else takes ``from_dict``'s value.  Inputs are
    not mutated."""
    out: Dict = copy.deepcopy(dict(onto))
    for k, v in from_dict.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = deep_merge_dicts(out[k], v)
        else:
            out[k] = v
    return out


def merge_dicts(*dicts: Mapping[Any, Any]) -> Dict[Any, Any]:
    """Shallow union; latest dict wins on key conflicts."""
    if len(dicts) < 2:
        raise ValueError("merge_dicts expects 2 or more dicts")
    out: Dict[Any, Any] = {}
    for d in dicts:
        out.update(d)
    return out
