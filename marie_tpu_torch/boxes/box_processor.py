"""BoxProcessor — the word detector's base (port of
``marie_tpu/boxes/box_processor.py``): :meth:`BoxProcessor.organize_boxes`
groups raw detections into lines and reading order, and
:meth:`BoxProcessor.extract_bounding_boxes` cuts a page into host
fragments by page segmentation mode (WORD and RAW_LINE: the whole image;
MULTI_LINE: lines of the ink projection; SPARSE and LINE: detection), as
the JAX package does; :func:`estimate_character_width` is copied with it.
The JAX base's YAML binding is not ported.
"""

from abc import ABC, abstractmethod
from typing import Sequence, Tuple

import numpy as np

from marie_tpu_torch.boxes.line_processor import assign_line_numbers, line_merge
from marie_tpu_torch.enums import PSMode


def estimate_character_width(boxes: Sequence[Sequence[float]], texts: Sequence[str]) -> int:
    """Average character width from recognised words."""
    total_chars = sum(len(t) for t in texts)
    total_width = sum(b[2] for b in boxes)
    return int(total_width // total_chars) if total_chars else 8


class BoxProcessor(ABC):
    """Base box processor: subclasses implement :meth:`detect_words`."""

    @abstractmethod
    def detect_words(self, image: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """[H, W] or [H, W, 3] uint8 page -> (boxes_xywh [N,4] float, scores [N])."""

    def extract_bounding_boxes(self, queue_id: str, checksum: str, image: np.ndarray,
                               psmode: PSMode = PSMode.SPARSE):
        """(boxes [N, 4] xywh int in reading order, fragments (N cut-outs
        of the RGB page), line numbers [N] 1-based, per-box meta
        ``{"score"}``, line boxes [L, 4] xywh)."""
        del queue_id, checksum
        image = np_rgb(image)
        h, w = image.shape[:2]
        if psmode in (PSMode.WORD, PSMode.RAW_LINE):
            boxes = np.array([[0, 0, w, h]], dtype=np.float64)
            scores = np.ones((1,), np.float32)
        elif psmode == PSMode.MULTI_LINE:
            boxes, scores = self._lines_from_projection(image)
        else:  # SPARSE / LINE: word detection
            boxes, scores = self.detect_words(image)
        boxes_int, scores, lines, line_bboxes = self.organize_boxes(
            boxes, scores, (h, w), psmode)
        fragments = [image[y: y + bh, x: x + bw] for x, y, bw, bh in boxes_int]
        meta = [{"score": float(s)} for s in scores]
        return boxes_int, fragments, lines, meta, line_bboxes

    def _lines_from_projection(self, image: np.ndarray):
        """MULTI_LINE: line boxes from the rows of the page's horizontal
        ink projection (no word detection)."""
        gray = image.mean(axis=-1)
        ink = gray < max(gray.mean() * 0.7, 1.0)
        profile = ink.sum(axis=1)
        active = profile > max(1, int(0.002 * image.shape[1]))
        boxes = []
        start = None
        for y, a in enumerate(active):
            if a and start is None:
                start = y
            elif not a and start is not None:
                boxes.append(self._line_box(ink, start, y))
                start = None
        if start is not None:
            boxes.append(self._line_box(ink, start, len(active)))
        if not boxes:
            h, w = image.shape[:2]
            boxes = [[0, 0, w, h]]
        arr = np.asarray(boxes, np.float64)
        return arr, np.ones((len(arr),), np.float32)

    @staticmethod
    def _line_box(ink: np.ndarray, y0: int, y1: int):
        cols = np.nonzero(ink[y0:y1].any(axis=0))[0]
        x0 = int(cols[0]) if len(cols) else 0
        x1 = int(cols[-1]) + 1 if len(cols) else ink.shape[1]
        return [x0, y0, x1 - x0, y1 - y0]

    @staticmethod
    def organize_boxes(
        boxes,
        scores,
        image_hw,
        psmode: PSMode = PSMode.SPARSE,
        return_order: bool = False,
    ):
        """Line-group + reading-order raw detections.

        Returns (boxes_int [N,4] xywh, scores [N], lines [N] 1-based,
        line_bboxes [L,4]) with boxes sorted by (line, x).

        ``return_order``: additionally return the permutation mapping the
        organized position back to the input index (``out[j] = in[order[j]]``)
        — the fused path uses it to align decoded rows.
        """
        h, w = image_hw
        if len(boxes) == 0:
            empty = (
                np.zeros((0, 4), np.int32),
                np.zeros((0,), np.float32),
                np.zeros((0,), np.int32),
                np.zeros((0, 4), np.int32),
            )
            return (*empty, np.zeros((0,), np.int64)) if return_order else empty

        if psmode in (PSMode.LINE, PSMode.RAW_LINE, PSMode.WORD, PSMode.MULTI_LINE):
            # single-line modes: each box is its own line (top-to-bottom)
            pre = np.argsort(np.asarray(boxes)[:, 1])
            boxes = np.asarray(boxes)[pre]
            scores = np.asarray(scores)[pre]
            line_bboxes = [list(map(int, b)) for b in boxes]
            lines = np.arange(1, len(boxes) + 1, dtype=np.int32)
        else:
            pre = np.arange(len(boxes))
            line_bboxes = line_merge(None, boxes)
            lines = assign_line_numbers(line_bboxes, boxes)

        # reading order: by (line, x)
        order = np.lexsort((np.asarray(boxes)[:, 0], lines))
        boxes = np.asarray(boxes)[order]
        scores = np.asarray(scores)[order]
        lines = lines[order]

        boxes_int = np.round(boxes).astype(np.int32)
        boxes_int[:, 0] = np.clip(boxes_int[:, 0], 0, w - 1)
        boxes_int[:, 1] = np.clip(boxes_int[:, 1], 0, h - 1)
        boxes_int[:, 2] = np.clip(boxes_int[:, 2], 1, w)
        boxes_int[:, 3] = np.clip(boxes_int[:, 3], 1, h)
        out = (boxes_int, scores, lines, np.asarray(line_bboxes, np.int32))
        if return_order:
            return (*out, pre[order])
        return out


def np_rgb(image: np.ndarray) -> np.ndarray:
    """[H, W] -> [H, W, 3]; [H, W, 4] -> its first three channels."""
    if image.ndim == 2:
        return np.stack([image] * 3, axis=-1)
    if image.shape[-1] == 4:
        return image[..., :3]
    return image
