"""PipelineOcrEngine — the port's entry point for batched page OCR.

Pages are bucket-padded on the host, grouped (same bucket, at most
``page_batch`` pages, padded to a power-of-two ladder size), uploaded as
uint8 and run through :func:`marie_tpu_torch.ocr.fused.fused_pages_compact`.
The collect follows ``marie_tpu/ocr/fused.py::fused_collect_many`` at word
level: per page, the kept boxes in original-page xywh with their text and
confidence.  Line organisation is not ported.
"""

from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
from torch.profiler import record_function

from marie_tpu_torch.models.configs import CraftConfig, TrOCRConfig
from marie_tpu_torch.models.tokenizer import CharTokenizer
from marie_tpu_torch.models.trocr import greedy_decode
from marie_tpu_torch.ocr.fused import (
    _geometric_step_caps,
    fused_pages_compact,
    host_keep_rows,
)
from marie_tpu_torch.ops.kernels.crop_resize import crop_resize
from marie_tpu_torch.preprocess.buckets import BucketSpec, pad_to
from marie_tpu_torch.registry.convert import init_flax_layout, load_model
from marie_tpu_torch.utils.device import resolve_device

Word = Dict[str, Any]


def _as_page_list(pages) -> List[np.ndarray]:
    """[H, W] / [H, W, 3|4] -> one page; [P, H, W] / [P, H, W, C] or a
    list -> pages."""
    if isinstance(pages, np.ndarray):
        if pages.ndim == 2 or (pages.ndim == 3 and pages.shape[-1] in (3, 4)):
            return [pages]
        return list(pages)
    return list(pages)


def _to_gray(page: np.ndarray) -> np.ndarray:
    if page.dtype != np.uint8:
        raise ValueError(f"pages must be uint8, got {page.dtype}")
    if page.ndim == 2:
        return page
    rgb = page[..., :3]
    if not (np.array_equal(rgb[..., 0], rgb[..., 1])
            and np.array_equal(rgb[..., 0], rgb[..., 2])):
        raise NotImplementedError(
            "RGB pages with distinct channels need the RGB crop path, "
            "which is not ported; pass grayscale pages")
    return np.ascontiguousarray(rgb[..., 0])


def _ladder_size(n: int, cap: int) -> int:
    """Smallest power of two >= n, capped."""
    s = 1
    while s < n and s < cap:
        s *= 2
    return min(s, cap)


class PipelineOcrEngine:
    """CRAFT detection + TrOCR greedy recognition over page batches.

    Weights are flax-layout numpy trees (see
    :mod:`marie_tpu_torch.registry.convert`); a missing tree is drawn from
    ``seed`` with :func:`init_flax_layout`.  CRAFT runs in float32, TrOCR
    in ``trocr_dtype`` (bf16, as the JAX serving processor runs it).
    Thresholds default to ``BoxProcessorCraft``'s; ``compact_slots`` is
    each page's share of a group's recognition rows."""

    def __init__(
        self,
        craft_config: Optional[CraftConfig] = None,
        trocr_config: Optional[TrOCRConfig] = None,
        craft_weights: Optional[Dict[str, Any]] = None,
        trocr_weights: Optional[Dict[str, Any]] = None,
        *,
        device="cuda",
        seed: int = 0,
        text_threshold: float = 0.7,
        low_text: float = 0.4,
        link_threshold: float = 0.4,
        min_area: float = 10,
        box_expand: float = 0.14,
        max_components: int = 1024,
        page_batch: int = 16,
        compact_slots: int = 192,
        trocr_dtype: torch.dtype = torch.bfloat16,
        decode_steps: Optional[int] = None,
        bucket_spec: Optional[BucketSpec] = None,
    ):
        self.device = resolve_device(device)
        self.craft_config = craft_config or CraftConfig.fast_s2d2()
        self.trocr_config = trocr_config or TrOCRConfig.fast_v3_g2_d6()
        if craft_weights is None:
            craft_weights = init_flax_layout(self.craft_config, seed)
        if trocr_weights is None:
            trocr_weights = init_flax_layout(self.trocr_config, seed + 1)
        self.craft = load_model(self.craft_config, craft_weights, self.device)
        self.trocr = load_model(self.trocr_config, trocr_weights, self.device,
                                trocr_dtype)
        self.trocr_dtype = trocr_dtype
        self.tokenizer = CharTokenizer()
        self.text_threshold = text_threshold
        self.low_text = low_text
        self.link_threshold = link_threshold
        self.min_area = float(min_area)
        self.box_expand = box_expand
        self.max_components = max_components
        self.page_batch = page_batch
        self.compact_slots = compact_slots
        self.crop_h, self.crop_w = self.trocr_config.encoder.image_size
        if decode_steps is None:
            max_chars = max(self.crop_w // max(self.crop_h // 2, 1), 4)
            decode_steps = min(max_chars + 4, self.trocr_config.decoder.max_len)
        self.decode_steps = decode_steps
        self.buckets = bucket_spec or BucketSpec()

    def _prep(self, page: np.ndarray):
        gray = _to_gray(page)
        h, w = gray.shape
        (bh, bw), scale = self.buckets.fit_with_scale(h, w)
        if scale < 1.0:
            raise NotImplementedError(
                f"page {h}x{w} exceeds the largest bucket; downscaling is "
                "not ported")
        return pad_to(gray, bh, bw), scale, (h, w)

    def _groups(self, preps) -> List[List[int]]:
        groups: List[List[int]] = []
        for i, prep in enumerate(preps):
            g = groups[-1] if groups else None
            if g and preps[g[0]][0].shape == prep[0].shape and len(g) < self.page_batch:
                g.append(i)
            else:
                groups.append([i])
        return groups

    def extract(self, pages_u8: Union[np.ndarray, Sequence[np.ndarray]],
                box_source: str = "heatmap") -> List[List[Word]]:
        """OCR every page: one list of words per page, each word
        ``{"box": [x, y, w, h] (original page pixels), "text": str,
        "confidence": float}`` in detection (slot) order."""
        preps = [self._prep(p) for p in _as_page_list(pages_u8)]
        out: List[List[Word]] = []
        for group in self._groups(preps):
            out.extend(self._run_group(preps, group, box_source))
        return out

    def _run_group(self, preps, group, box_source) -> List[List[Word]]:
        psize = _ladder_size(len(group), self.page_batch)
        rows = group + [group[-1]] * (psize - len(group))
        stack = torch.from_numpy(np.stack([preps[k][0] for k in rows]))
        clip = torch.tensor(
            [[preps[k][2][1] * preps[k][1], preps[k][2][0] * preps[k][1]]
             for k in rows], dtype=torch.float32)
        total_slots = psize * self.compact_slots
        expand = self.box_expand if box_source == "heatmap" else 0.0
        pages_dev = stack.to(self.device)
        stats, tokens, conf, crop_rows = fused_pages_compact(
            self.craft, self.trocr, pages_dev, clip, len(group),
            self.text_threshold, self.low_text, self.link_threshold,
            self.min_area, expand, self.max_components, box_source,
            total_slots, self.crop_h, self.crop_w, self.trocr_dtype,
            self.decode_steps)
        with record_function("marie.collect"):
            pages_words, overflow = self._collect(
                preps, group, stats, tokens, conf, total_slots, box_source, expand)
        if overflow:
            with record_function("marie.overflow"):
                self._recognize_overflow(pages_dev, crop_rows, overflow, pages_words)
        return pages_words

    def _collect(self, preps, group, stats, tokens, conf, total_slots,
                 box_source, expand):
        """Host side of the row contract: per page, the kept boxes in
        original-page xywh with the text of their decoded row; kept boxes
        past ``total_slots`` are returned as overflow to recognise."""
        stats_np = {k: v.cpu().numpy() for k, v in stats.items()}
        texts = self.tokenizer.decode_batch(tokens.cpu().numpy())
        conf_np = conf.cpu().numpy().astype(np.float64)
        pages_words: List[List[Word]] = []
        overflow = []  # (page slot, word index, compaction row)
        row_base = 0
        for s, k in enumerate(group):
            stats_i = {key: v[s] for key, v in stats_np.items()}
            keep = host_keep_rows(stats_i, box_source, self.text_threshold,
                                  self.min_area)
            scale, (h, w) = preps[k][1], preps[k][2]
            stride = float(stats_i["stride"])
            grid = stats_i["boxes"][keep]
            boxes = grid * stride / scale
            if expand > 0 and len(boxes):
                bw = boxes[:, 2] - boxes[:, 0]
                bh = boxes[:, 3] - boxes[:, 1]
                boxes = boxes + np.stack(
                    [-bw * expand, -bh * expand, bw * expand, bh * expand], -1)
            boxes[:, 0] = np.clip(boxes[:, 0], 0, w)
            boxes[:, 1] = np.clip(boxes[:, 1], 0, h)
            boxes[:, 2] = np.clip(boxes[:, 2], 0, w)
            boxes[:, 3] = np.clip(boxes[:, 3], 0, h)
            words: List[Word] = []
            for j in range(len(boxes)):
                x0, y0, x1, y1 = (float(v) for v in boxes[j])
                if not (x1 - x0 > 0 and y1 - y0 > 0):
                    continue
                row = row_base + j
                word = {"box": [x0, y0, x1 - x0, y1 - y0], "text": "",
                        "confidence": 0.0}
                if row < total_slots:
                    word["text"] = texts[row]
                    word["confidence"] = float(conf_np[row])
                else:
                    overflow.append((s, len(words), row))
                words.append(word)
            pages_words.append(words)
            row_base += int(keep.sum())
        return pages_words, overflow

    def _recognize_overflow(self, pages_dev, crop_rows, overflow, pages_words) -> None:
        """Recognise the kept boxes past the group's row budget in one
        extra crop + decode batch, with the crop boxes the page program
        computed for them."""
        boxes, page_of = crop_rows
        rows = torch.tensor([o[2] for o in overflow], dtype=torch.long,
                            device=self.device)
        crops, eff_w = crop_resize(pages_dev, page_of[rows], boxes[rows],
                                   self.crop_h, self.crop_w)
        crops = crops[..., None].expand(*crops.shape, 3)
        tokens, _, conf = greedy_decode(
            self.trocr, crops.to(self.trocr_dtype), self.decode_steps,
            step_caps=_geometric_step_caps(eff_w, self.crop_h, self.decode_steps))
        texts = self.tokenizer.decode_batch(tokens.cpu().numpy())
        for (s, j, _), text, c in zip(overflow, texts, conf.cpu().tolist()):
            pages_words[s][j]["text"] = text
            pages_words[s][j]["confidence"] = float(c)
