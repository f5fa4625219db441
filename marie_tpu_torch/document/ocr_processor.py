"""OcrProcessor base and the page result schema (port of
``marie_tpu/document/ocr_processor.py``):

    result = {
      "meta":  {"imageSize": {...}, "page": 0, "lang": "en"},
      "words": [{"id", "text", "confidence", "box", "line", "word_index"}],
      "lines": [{"line", "wordids", "text", "bbox", "confidence"}],
    }

Words are re-indexed left-to-right, then aligned line-by-line; line text
is the space-join of its words; line bbox is the block union.  Pure
numpy, copied so that the port imports nothing of the JAX package.
"""

from abc import ABC, abstractmethod
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np


class OcrProcessor(ABC):
    """Recogniser base: word fragments -> words, and :meth:`recognize`,
    which aligns a page's recognised fragments into the result schema."""

    def is_available(self) -> bool:
        return True

    @abstractmethod
    def recognize_from_fragments(
        self, fragments: Sequence[np.ndarray]
    ) -> List[Dict[str, Any]]:
        """List of word images -> list of {"text", "confidence"}."""

    def recognize(
        self,
        queue_id: str,
        checksum: str,
        image: np.ndarray,
        boxes: Sequence[Sequence[int]],
        fragments: Sequence[np.ndarray],
        lines: Sequence[int],
        **kwargs,
    ) -> Tuple[Dict[str, Any], np.ndarray]:
        """Full-page recognition -> (result dict, overlay image: a white
        [H, W, 3] page, as in the JAX package)."""
        if not len(boxes) == len(fragments) == len(lines):
            raise ValueError(f"{len(boxes)} boxes, {len(fragments)} fragments and "
                             f"{len(lines)} line numbers")
        h, w = image.shape[0], image.shape[1]
        overlay = np.full((h, w, 3), 255, np.uint8)
        if len(boxes) == 0:
            return assemble_page_result((h, w), [], [], []), overlay
        results = self.recognize_from_fragments(fragments)
        if len(results) != len(fragments):
            raise ValueError(f"{len(results)} results for {len(fragments)} fragments")
        return assemble_page_result((h, w), boxes, lines, results), overlay


def assemble_page_result(
    image_hw: Tuple[int, int],
    boxes: Sequence[Sequence[int]],
    lines: Sequence[int],
    results: Sequence[Dict[str, Any]],
) -> Dict[str, Any]:
    """Build the page result schema from recognised words.

    Words are re-indexed left-to-right then aligned line-by-line; each
    line's text is the space-join of its words, bbox the block union.
    """
    h, w = image_hw
    meta = {
        "imageSize": {"width": int(w), "height": int(h)},
        "page": 0,
        "lang": "en",
    }
    if len(boxes) == 0:
        return {"meta": meta, "words": [], "lines": []}

    boxes_arr = np.asarray(boxes)
    lines_arr = np.asarray(lines)
    order = np.argsort(boxes_arr[:, 0], kind="stable")
    obox = boxes_arr[order].astype(np.int64).tolist()
    olines = lines_arr[order].astype(np.int64).tolist()
    # python round(), not np.round — the decimal-correct halfway cases
    # are pinned by the JAX package's golden-output tests
    conf3 = [round(float(results[i]["confidence"]), 3) for i in order]
    conf3_arr = np.asarray(conf3, np.float64)

    words: List[Dict[str, Any]] = []
    for i, idx in enumerate(order):
        ext = results[idx]
        wd = {
            "id": i,
            "text": ext["text"],
            "confidence": conf3[i],
            "box": obox[i],
            "line": olines[i],
        }
        # carry extra per-word annotations
        for k, v in ext.items():
            if k not in wd:
                wd[k] = v
        words.append(wd)

    # group by line: stable sort keeps the x-order within each line
    line_perm = np.argsort(np.asarray(olines), kind="stable")
    sorted_lines = np.asarray(olines)[line_perm]
    starts = np.flatnonzero(
        np.r_[True, sorted_lines[1:] != sorted_lines[:-1]]
    )
    bounds = np.r_[starts, len(sorted_lines)]
    # per-line block bbox + mean confidence via reduceat, from the word
    # boxes as they appear in word["box"]
    b = np.asarray(obox, np.float64)[line_perm]
    x0 = np.minimum.reduceat(b[:, 0], starts)
    y0 = np.minimum.reduceat(b[:, 1], starts)
    x1 = np.maximum.reduceat(b[:, 0] + b[:, 2], starts)
    y1 = np.maximum.reduceat(b[:, 1] + b[:, 3], starts)
    conf_by_line = conf3_arr[line_perm]
    bbox_arr = np.stack([x0, y0, x1 - x0, y1 - y0], -1).astype(np.int64)
    bbox_lists = bbox_arr.tolist()

    aligned_words: List[Dict[str, Any]] = []
    line_results: List[Dict[str, Any]] = []
    perm_list = line_perm.tolist()
    for li in range(len(starts)):
        picks = [words[perm_list[j]] for j in range(bounds[li], bounds[li + 1])]
        for wd in picks:
            wd["word_index"] = len(aligned_words)
            aligned_words.append(wd)
        line_results.append(
            {
                "line": li + 1,
                "wordids": [wd["id"] for wd in picks],
                "text": " ".join(wd["text"] for wd in picks),
                "bbox": bbox_lists[li],
                # np.mean over the python-rounded confs
                "confidence": round(
                    float(np.mean(conf_by_line[bounds[li]:bounds[li + 1]])), 4
                ),
            }
        )
    return {"meta": meta, "words": aligned_words, "lines": line_results}
