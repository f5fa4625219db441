"""Result-drift checker (copy of ``marie_tpu/check.py``, with the
character error rate of ``marie_tpu/train/recognizer.py``): compares two
OCR result sets in the meta/words/lines schema — detection precision,
recall and IoU, recognition CER — and, for two runs of the same engine,
how far their words and labels agree (:func:`agreement`)."""

from typing import Any, Dict, List, Sequence

import numpy as np

from marie_tpu_torch.utils.overlap import compute_iou


def character_error_rate(pred: str, truth: str) -> float:
    """Levenshtein distance / len(truth)."""
    m, n = len(pred), len(truth)
    if n == 0:
        return float(m > 0)
    prev = list(range(n + 1))
    for i in range(1, m + 1):
        cur = [i] + [0] * n
        for j in range(1, n + 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1,
                         prev[j - 1] + (pred[i - 1] != truth[j - 1]))
        prev = cur
    return prev[n] / n


def _to_xyxy(box) -> List[float]:
    x, y, w, h = box
    return [x, y, x + w, y + h]


def match_words(
    golden_words: Sequence[Dict[str, Any]],
    candidate_words: Sequence[Dict[str, Any]],
    iou_threshold: float = 0.5,
):
    """Greedy IoU matching of word boxes. Returns list of (g_idx, c_idx)."""
    pairs = []
    used = set()
    for gi, gw in enumerate(golden_words):
        best, best_iou = None, iou_threshold
        for ci, cw in enumerate(candidate_words):
            if ci in used:
                continue
            iou = compute_iou(_to_xyxy(gw["box"]), _to_xyxy(cw["box"]))
            if iou > best_iou:
                best, best_iou = ci, iou
        if best is not None:
            used.add(best)
            pairs.append((gi, best))
    return pairs


def compare_results(
    golden: List[Dict[str, Any]],
    candidate: List[Dict[str, Any]],
    iou_threshold: float = 0.5,
) -> Dict[str, Any]:
    """Page-list vs page-list drift report.

    Returns {detection: {precision, recall, mean_iou}, recognition: {cer},
    pages: N, drift_detected: bool}.
    """
    tp = fp = fn = 0
    ious: List[float] = []
    cers: List[float] = []
    for g_page, c_page in zip(golden, candidate):
        gws = g_page.get("words", [])
        cws = c_page.get("words", [])
        pairs = match_words(gws, cws, iou_threshold)
        tp += len(pairs)
        fn += len(gws) - len(pairs)
        fp += len(cws) - len(pairs)
        for gi, ci in pairs:
            ious.append(compute_iou(_to_xyxy(gws[gi]["box"]), _to_xyxy(cws[ci]["box"])))
            cers.append(character_error_rate(str(cws[ci]["text"]), str(gws[gi]["text"])))
    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    report = {
        "pages": len(golden),
        "detection": {
            "precision": round(precision, 4),
            "recall": round(recall, 4),
            "mean_iou": round(float(np.mean(ious)) if ious else 0.0, 4),
            "matched": tp,
            "missing": fn,
            "spurious": fp,
        },
        "recognition": {
            "cer": round(float(np.mean(cers)) if cers else 1.0, 4),
        },
    }
    report["drift_detected"] = (
        precision < 0.95 or recall < 0.95 or report["recognition"]["cer"] > 0.05
    )
    return report


def truth_pages(truths, sizes) -> List[Dict[str, Any]]:
    """Ground truth as result dicts: ``truths`` per page ``[(text, xywh),
    ...]``, ``sizes`` per page (height, width)."""
    return [
        {"meta": {"imageSize": {"width": int(w), "height": int(h)}},
         "words": [{"id": i, "text": t, "box": list(b), "confidence": 1.0, "line": 1}
                   for i, (t, b) in enumerate(truth)],
         "lines": []}
        for truth, (h, w) in zip(truths, sizes)
    ]


def agreement(golden: List[Dict[str, Any]], candidate: List[Dict[str, Any]],
              iou_threshold: float = 0.5) -> Dict[str, Any]:
    """How far two runs agree, page by page (a golden word and a
    candidate word match at IoU >= ``iou_threshold``): ``words``, the
    share of golden words matched with equal text; ``ner``, the share of
    matched words with equal ``ner_label``; ``labels``, the share of pages
    with equal ``classification`` label (of the pages both runs
    classified); ``label_pages``, the pages whose labels differ although
    every golden word was matched with equal text; ``box_pages``, the
    pages with NER labels whose word boxes all equal the golden's (the
    NER heads see the same words there); ``ner_pages``, those of them
    whose NER labels differ.  A share with nothing to count is None."""
    n_words = n_same = n_ner = n_ner_same = n_pages = n_label_same = 0
    label_pages, box_pages, ner_pages = [], [], []
    for p, (g_page, c_page) in enumerate(zip(golden, candidate)):
        gws, cws = g_page.get("words", []), c_page.get("words", [])
        pairs = match_words(gws, cws, iou_threshold)
        same = sum(gws[gi]["text"] == cws[ci]["text"] for gi, ci in pairs)
        n_words += len(gws)
        n_same += same
        ner_same = [gws[gi]["ner_label"] == cws[ci].get("ner_label")
                    for gi, ci in pairs if "ner_label" in gws[gi]]
        n_ner += len(ner_same)
        n_ner_same += sum(ner_same)
        if ner_same and sorted(map(tuple, (w["box"] for w in gws))) == sorted(
                map(tuple, (w["box"] for w in cws))):
            box_pages.append(p)
            if not all(ner_same):
                ner_pages.append(p)
        if "classification" in g_page and "classification" in c_page:
            n_pages += 1
            equal = g_page["classification"].get("label") == c_page["classification"].get("label")
            n_label_same += equal
            if not equal and same == len(gws) and len(cws) == len(gws):
                label_pages.append(p)
    return {
        "words": n_same / max(n_words, 1),
        "ner": n_ner_same / n_ner if n_ner else None,
        "labels": n_label_same / n_pages if n_pages else None,
        "label_pages": label_pages,
        "box_pages": box_pages,
        "ner_pages": ner_pages,
        "golden_words": n_words,
    }
