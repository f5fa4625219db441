"""OCR debug visualisation and training-data harvesting (port of
``marie_tpu/utils/visualize.py``): word boxes drawn over a page, coloured
by confidence, and low-confidence word crops dumped under filesystem-safe
names.

The boxes are Pillow's (``utils/pil_ops.py::draw_rectangle``, to the bit).
The labels are drawn by the glyph atlas in DejaVuSans at LABEL_SIZE px,
where PIL draws them in its default font (Pillow 12: Aileron at 10 px),
which the atlas does not hold; a character the atlas lacks is drawn as
``?``.  Files are written by ``utils/image_io.py``: PNG (the crops and a
``.png`` overlay) and TIFF (a ``.tif`` / ``.tiff`` overlay), with the
pixels PIL would write and other bytes; any other extension raises."""

import os
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from marie_tpu_torch.helper import ensure_exists
from marie_tpu_torch.utils.image_io import drop_alpha, write_png, write_tiff
from marie_tpu_torch.utils.pil_ops import draw_rectangle

# confidence -> overlay colour (high=green, mid=orange, low=red)
_BANDS = ((0.95, (0, 170, 0)), (0.8, (255, 140, 0)), (0.0, (220, 30, 30)))
LABEL_FACE = "DejaVuSans"
LABEL_SIZE = 11


def _color_for(conf: float) -> Tuple[int, int, int]:
    for floor, color in _BANDS:
        if conf >= floor:
            return color
    return _BANDS[-1][1]


def normalize_label(text: str) -> str:
    """Filesystem-safe crop name: one regex pass, ``blank`` when empty."""
    safe = re.sub(r"[^A-Za-z0-9]+", "_", text).strip("_")
    return safe or "blank"


def _to_rgb(frame: np.ndarray) -> np.ndarray:
    """``Image.fromarray(frame).convert("RGB")`` of a uint8 page."""
    img = drop_alpha(np.asarray(frame, np.uint8))
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    return np.ascontiguousarray(img)


def _write(path: str, img: np.ndarray) -> None:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        write_png(path, img)
    elif ext in (".tif", ".tiff"):
        write_tiff(path, [img])
    else:
        raise ValueError(f"draw_ocr_overlay writes .png and .tif files, not {path!r}")


def draw_ocr_overlay(
    frame: np.ndarray,
    ocr_result: Dict[str, Any],
    path: Optional[str] = None,
    show_text: bool = True,
) -> np.ndarray:
    """Word boxes (coloured by confidence, outline 2 px) and, with
    ``show_text``, each word's text and confidence above it, on an RGB
    copy of the page; saved to ``path`` when given."""
    img = _to_rgb(frame)
    font = None
    if show_text:
        from marie_tpu_torch.utils.glyphs import load_font

        font = load_font(LABEL_FACE, LABEL_SIZE)
    for w in ocr_result.get("words", []):
        x, y, bw, bh = [int(v) for v in w.get("box", (0, 0, 0, 0))]
        conf = float(w.get("confidence", 1.0))
        color = _color_for(conf)
        draw_rectangle(img, [x, y, x + bw, y + bh], outline=color, width=2)
        if font is not None and w.get("text"):
            label = "".join(c if font.has_glyph(c) else "?" for c in f"{w['text']} {conf:.2f}")
            font.draw_text(img, (x, max(y - 12, 0)), label, fill=color)
    if path:
        _write(path, img)
    return img


def dump_low_confidence_crops(
    frame: np.ndarray,
    ocr_result: Dict[str, Any],
    out_dir: str,
    threshold: float = 0.90,
    pad: int = 2,
) -> List[str]:
    """Save a PNG crop of each word whose confidence is below
    ``threshold``, named ``{conf:.4f}_{text}_{i}.png``.  Returns the
    written paths."""
    ensure_exists(out_dir)
    arr = np.asarray(frame)
    h, w_img = arr.shape[:2]
    written: List[str] = []
    for i, w in enumerate(ocr_result.get("words", [])):
        conf = float(w.get("confidence", 1.0))
        if conf >= threshold:
            continue
        x, y, bw, bh = [int(v) for v in w.get("box", (0, 0, 0, 0))]
        x0, y0 = max(x - pad, 0), max(y - pad, 0)
        x1, y1 = min(x + bw + pad, w_img), min(y + bh + pad, h)
        if x1 <= x0 or y1 <= y0:
            continue
        name = f"{conf:.4f}_{normalize_label(w.get('text', ''))[:48]}_{i}.png"
        path = os.path.join(out_dir, name)
        write_png(path, drop_alpha(arr[y0:y1, x0:x1]))
        written.append(path)
    return written
