"""BoxProcessor — the word detector's base (port of
``marie_tpu/boxes/box_processor.py``): :meth:`BoxProcessor.organize_boxes`
groups raw detections into lines and reading order, as the JAX package
does, and :func:`estimate_character_width` is copied with it.

Left for later (ROADMAP §1 item 8): the YAML binding of the JAX base and
``extract_bounding_boxes``, whose fragment cutting and line projection
serve only the non-fused path.
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
