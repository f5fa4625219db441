"""Per-node document conditions (copy of
``marie_tpu/serve/runtimes/gateway/conditions.py``): a flow node given
``when=`` receives only the documents that match; the rest pass it by and
join its output.

Operators: exact match, ``{"$in": [...]}``, ``{"$exists": bool}``,
``{"$gt"/"$gte"/"$lt"/"$lte": n}``, ``{"$ne": v}``.  Field paths use
``__`` separators into tags (``tags__type``) or top-level document
fields (``text``, ``uri``, ...).
"""

from typing import Any, Dict, Optional

from marie_tpu_torch.types.docs import Document


def _resolve(doc: Document, path: str):
    parts = path.split("__")
    cur: Any = doc
    for i, part in enumerate(parts):
        if isinstance(cur, Document):
            if part == "tags":
                cur = cur.tags
            else:
                cur = getattr(cur, part, None)
        elif isinstance(cur, dict):
            cur = cur.get(part)
        else:
            return None, False
        if cur is None and i < len(parts) - 1:
            return None, False
    # existence: walk again to tell None-value from missing-key
    exists = True
    probe: Any = doc
    for part in parts:
        if isinstance(probe, Document):
            if part == "tags":
                probe = probe.tags
            elif hasattr(probe, part):
                probe = getattr(probe, part)
            else:
                exists = False
                break
        elif isinstance(probe, dict):
            if part in probe:
                probe = probe[part]
            else:
                exists = False
                break
        else:
            exists = False
            break
    return cur, exists


def doc_matches(doc: Document, condition: Optional[Dict[str, Any]]) -> bool:
    """Does the doc satisfy the condition? (AND over fields)."""
    if not condition:
        return True
    for path, expected in condition.items():
        value, exists = _resolve(doc, path)
        if isinstance(expected, dict):
            for op, operand in expected.items():
                if op == "$exists":
                    if bool(exists) != bool(operand):
                        return False
                elif op == "$in":
                    if value not in operand:
                        return False
                elif op == "$ne":
                    if value == operand:
                        return False
                elif op == "$gt":
                    if not (exists and value is not None and value > operand):
                        return False
                elif op == "$gte":
                    if not (exists and value is not None and value >= operand):
                        return False
                elif op == "$lt":
                    if not (exists and value is not None and value < operand):
                        return False
                elif op == "$lte":
                    if not (exists and value is not None and value <= operand):
                        return False
                else:
                    raise ValueError(f"unsupported condition operator {op!r}")
        else:
            if not exists or value != expected:
                return False
    return True
