"""Entity aggregation (copy of
``marie_tpu/components/document_indexer/aggregation.py``): word-level BIO
predictions are grouped by text line, contiguous same-key runs become
LineGroups, horizontally-overlapping fragments of one key merge (the
mislabeled-token repair), and vertically-proximate lines assemble into
composite EntityGroups (e.g. a multi-line ADDRESS block from
street/city/zip keys).  Host numpy, after the heads.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

from marie_tpu_torch.boxes.line_processor import find_line_number
from marie_tpu_torch.utils.overlap import (
    find_overlap_horizontal,
    merge_bboxes_as_block,
)


@dataclasses.dataclass
class LineGroup:
    """One contiguous same-key span on one text line."""

    line: int
    key: str
    bbox: List[int]          # xywh
    score: float
    word_indexes: List[int]


@dataclasses.dataclass
class EntityGroup:
    """A composite entity assembled from proximate LineGroups."""

    key: str
    bbox: List[int]          # xywh
    components: List[str]    # distinct keys contained
    groups: List[LineGroup]
    score: float


def group_predictions_by_line(
    lines_bboxes: Sequence[Sequence[float]],
    boxes: Sequence[Sequence[float]],
    predictions: Sequence[str],
) -> Dict[int, List[int]]:
    """Map non-O word predictions to 1-based line numbers.

    Degenerate boxes (zero w/h) are discarded like the reference's
    ``group_by_line``.
    """
    groups: Dict[int, List[int]] = {}
    for idx, (pred, box) in enumerate(zip(predictions, boxes)):
        if len(pred) < 3 or not pred[2:]:
            continue  # 'O'
        if box[2] <= 0 or box[3] <= 0:
            continue
        line = find_line_number(lines_bboxes, box)
        groups.setdefault(line, []).append(idx)
    return groups


def key_spans(
    indexes: Sequence[int], predictions: Sequence[str], key: str
) -> List[List[int]]:
    """Contiguous runs of ``key`` within the (ordered) index list."""
    spans: List[List[int]] = []
    run: List[int] = []
    for idx in indexes:
        if predictions[idx][2:] == key:
            run.append(idx)
        elif run:
            spans.append(run)
            run = []
    if run:
        spans.append(run)
    return spans


def aggregate_lines(
    expected_keys: Sequence[str],
    line_groups: Dict[int, List[int]],
    boxes: Sequence[Sequence[float]],
    predictions: Sequence[str],
    scores: Sequence[float],
) -> Dict[int, List[LineGroup]]:
    """Per line, one LineGroup per contiguous same-key span."""
    boxes = np.asarray(boxes, np.float64)
    scores = np.asarray(scores, np.float64)
    out: Dict[int, List[LineGroup]] = {}
    for line, idxs in sorted(line_groups.items()):
        for key in expected_keys:
            for span in key_spans(idxs, predictions, key):
                out.setdefault(line, []).append(
                    LineGroup(
                        line=line,
                        key=key,
                        bbox=merge_bboxes_as_block(boxes[span]),
                        score=float(round(scores[span].mean(), 6)),
                        word_indexes=list(span),
                    )
                )
    return out


def merge_mislabeled(
    expected_keys: Sequence[str],
    aggregated: Dict[int, List[LineGroup]],
) -> Dict[int, List[LineGroup]]:
    """Merge horizontally-overlapping same-key fragments on a line.

    A mislabeled token splits B-PAN I-PAN [B-ANS] I-PAN into two PAN
    groups that overlap horizontally; the reference's ``aggregate``
    strategy unions them back (transformers.py:1072-1124).
    """
    out: Dict[int, List[LineGroup]] = {}
    for line, items in aggregated.items():
        merged: List[LineGroup] = []
        for key in expected_keys:
            same = [g for g in items if g.key == key]
            visited = [False] * len(same)
            bboxes = [g.bbox for g in same]
            for i, g in enumerate(same):
                if visited[i]:
                    continue
                visited[i] = True
                _, overlap_idx, _ = find_overlap_horizontal(g.bbox, bboxes)
                cluster = [g]
                for j in overlap_idx:
                    if j != i and not visited[j]:
                        visited[j] = True
                        cluster.append(same[j])
                if len(cluster) == 1:
                    merged.append(g)
                else:
                    merged.append(
                        LineGroup(
                            line=line,
                            key=key,
                            bbox=merge_bboxes_as_block(
                                [c.bbox for c in cluster]
                            ),
                            score=float(
                                round(
                                    np.mean([c.score for c in cluster]), 6
                                )
                            ),
                            word_indexes=sorted(
                                sum((c.word_indexes for c in cluster), [])
                            ),
                        )
                    )
        # keys outside expected_keys pass through untouched
        merged.extend(g for g in items if g.key not in expected_keys)
        out[line] = merged
    return out


def group_composites(
    definitions: Sequence[Dict],
    lines_bboxes: Sequence[Sequence[float]],
    boxes: Sequence[Sequence[float]],
    predictions: Sequence[str],
    scores: Sequence[float],
    max_line_gap: int = 2,
) -> Dict[str, List[EntityGroup]]:
    """Assemble composite entities from grouped line predictions.

    ``definitions``: [{"name": "ADDRESS", "entities": ["STREET", "CITY",
    "ZIP"]}, ...].  LineGroups whose keys belong to a definition and
    whose lines are within ``max_line_gap`` of each other merge into one
    EntityGroup (the reference's collected_groups/merge_groups pass,
    transformers.py:748-800).
    """
    result: Dict[str, List[EntityGroup]] = {}
    for definition in definitions:
        name = definition["name"]
        keys = list(definition["entities"])
        # filter predictions down to this definition's keys
        fidx = [i for i, p in enumerate(predictions) if p[2:] in keys]
        fboxes = [boxes[i] for i in fidx]
        fpreds = [predictions[i] for i in fidx]
        fscores = [scores[i] for i in fidx]
        line_groups = group_predictions_by_line(lines_bboxes, fboxes, fpreds)
        aggregated = merge_mislabeled(
            keys, aggregate_lines(keys, line_groups, fboxes, fpreds, fscores)
        )
        # restore original word indexes
        for items in aggregated.values():
            for g in items:
                g.word_indexes = [fidx[i] for i in g.word_indexes]

        # cluster lines by vertical proximity
        flat = [g for _, items in sorted(aggregated.items()) for g in items]
        clusters: List[List[LineGroup]] = []
        last_line = None
        for g in flat:
            if last_line is not None and g.line - last_line <= max_line_gap:
                clusters[-1].append(g)
            else:
                clusters.append([g])
            last_line = g.line

        entity_groups: List[EntityGroup] = []
        for cluster in clusters:
            # split a cluster into horizontally-coherent columns: two
            # side-by-side addresses on the same lines stay distinct
            cluster = sorted(cluster, key=lambda g: g.bbox[0])
            bboxes = [g.bbox for g in cluster]
            visited = [False] * len(cluster)
            for i in range(len(cluster)):
                if visited[i]:
                    continue
                visited[i] = True
                members = [cluster[i]]
                _, overlap_idx, _ = find_overlap_horizontal(
                    bboxes[i], bboxes
                )
                for j in overlap_idx:
                    if not visited[j]:
                        visited[j] = True
                        members.append(cluster[j])
                members = sorted(members, key=lambda g: g.line)
                entity_groups.append(
                    EntityGroup(
                        key=name,
                        bbox=merge_bboxes_as_block(
                            [m.bbox for m in members]
                        ),
                        components=sorted({m.key for m in members}),
                        groups=members,
                        score=float(
                            round(np.mean([m.score for m in members]), 6)
                        ),
                    )
                )
        result[name] = entity_groups
    return result
