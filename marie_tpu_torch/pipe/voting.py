"""Classifier voting (copy of ``marie_tpu/pipe/voting.py``)."""

from collections import Counter
from typing import Any, Dict, List

import numpy as np


def majority_vote(candidates: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Majority label across classifier outputs; ties broken by score."""
    if not candidates:
        return {"label": "unknown", "score": 0.0}
    labels = [c["label"] for c in candidates]
    counts = Counter(labels)
    top = counts.most_common(1)[0][1]
    tied = [l for l, n in counts.items() if n == top]
    best = max(
        tied,
        key=lambda l: max(c["score"] for c in candidates if c["label"] == l),
    )
    scores = [c["score"] for c in candidates if c["label"] == best]
    return {"label": best, "score": float(np.mean(scores))}
