"""CRAFT box processor (port of ``marie_tpu/boxes/craft_box_processor.py``):
:func:`detect_core` turns batched pages into fixed-size per-page component
stats on the device, and :class:`BoxProcessorCraft` wraps it in the JAX
package's detector API (page prep, dispatch, host collect).

The JAX version reads ``MARIE_CC_STATS``, ``MARIE_CC_MASK`` and
``MARIE_CC_RUNS`` from the environment while it traces; here they are the
keyword arguments ``cc_stats``, ``cc_mask`` and ``cc_runs`` with the same
defaults.  ``cc_stats`` names one of the five stats variants of
:mod:`marie_tpu_torch.ops.connected_components`: ``runs_cc`` works on the
mask, the other four on its pixel label map.
"""

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from marie_tpu_torch.boxes.box_processor import BoxProcessor, fit_to_bucket, np_rgb
from marie_tpu_torch.models.configs import CraftConfig
from marie_tpu_torch.ops.connected_components import (
    component_boxes,
    component_boxes_reduce,
    component_boxes_reduce2,
    component_boxes_runs,
    component_boxes_runs_cc,
    connected_components,
)
from marie_tpu_torch.preprocess.buckets import BucketSpec
from marie_tpu_torch.preprocess.ops import normalize_page, otsu_binarize, to_grayscale
from marie_tpu_torch.registry.convert import init_flax_layout, load_model
from marie_tpu_torch.utils.device import float32_precision, resolve_device

#: the stats variants by their ``MARIE_CC_STATS`` names (all give the same
#: stats; ``runs`` while rows hold at most 48 components)
CC_STATS = {
    "runs_cc": component_boxes_runs_cc,
    "runs": component_boxes_runs,
    "reduce": component_boxes_reduce,
    "reduce2": component_boxes_reduce2,
    "sort": component_boxes,
}
CC_MASKS = ("region", "region+affinity")


def _max_pool(x: torch.Tensor, window, stride, padding=(0, 0)) -> torch.Tensor:
    """``lax.reduce_window(max)`` of a [B, H, W] float map ('VALID', or
    symmetric -inf padding for 'SAME' with an odd window)."""
    return F.max_pool2d(x[:, None], window, stride, padding)[:, 0]


def heat_masks(heat: torch.Tensor, rgb: torch.Tensor, low_text: float,
               link_threshold: float, stride: int, box_source: str = "heatmap",
               cc_mask: str = "region"):
    """CRAFT heatmap [B, h, w, 2] (+ the normalized pages [B, H, W, 3] for
    ``box_source="ink"``) -> (CC mask, score map, grid stride)."""
    region = heat[..., 0]
    affinity = heat[..., 1]
    if box_source == "ink":
        # Otsu ink on a 4x coarse grid, joined horizontally into word blobs;
        # the heatmap term keeps the detector in the graph but never fires
        ink = otsu_binarize(to_grayscale(rgb)).to(torch.float32)
        ink4 = _max_pool(ink, (4, 4), (4, 4))
        region4 = _max_pool(region, (2, 2), (2, 2))
        joined = _max_pool(ink4, (1, 3), (1, 1), (0, 1))
        mask = (joined > 0) | (region4 > 2.0)
        scores = torch.maximum(ink4, region4 * 0.0) + 1e-3
        return mask, scores, 4
    if box_source != "heatmap":
        raise ValueError(f"box_source must be 'heatmap' or 'ink', got {box_source!r}")
    if cc_mask not in CC_MASKS:
        raise ValueError(f"cc_mask must be one of {CC_MASKS}, got {cc_mask!r}")
    if cc_mask == "region+affinity":
        mask = (region > low_text) | (affinity > link_threshold)
    else:
        mask = region > low_text
    return mask, region, stride


@torch.no_grad()
def craft_heatmap(model: nn.Module, pages_u8: torch.Tensor,
                  allow_tf32: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, H, W] or [B, H, W, 3] uint8 pages -> (normalized pages
    [B, H, W, 3] float32, CRAFT heatmap [B, h, w, 2] float32).  The pages
    go into the model in its parameters' dtype (bf16 CRAFT: the JAX
    version's ``rgb.astype(vdt)``); float32 convolutions run in full
    float32 unless ``allow_tf32``, whatever the global flags say."""
    if pages_u8.ndim == 3:
        pages_u8 = pages_u8[..., None].expand(*pages_u8.shape, 3)
    with record_function("marie.detect"):
        rgb = normalize_page(pages_u8)
        pdt = next(model.parameters()).dtype
        with float32_precision(allow_tf32):
            heat = model(rgb.to(pdt)).to(torch.float32)
    return rgb, heat


@torch.no_grad()
def detect_core(
    model: nn.Module,
    pages_u8: torch.Tensor,  # [B, H, W] or [B, H, W, 3] uint8 (same bucket)
    text_threshold: float,
    low_text: float,
    link_threshold: float,
    max_components: int,
    box_source: str = "heatmap",
    *,
    cc_stats: str = "runs_cc",
    cc_mask: str = "region",
    cc_runs: int = 48,
    allow_tf32: bool = False,
) -> Dict[str, torch.Tensor]:
    """Batched pages -> per-page component stats (boxes on the heatmap
    grid, areas, scores, valid, and the grid ``stride``).

    ``box_source="heatmap"`` masks the CRAFT region map at ``low_text``;
    ``"ink"`` runs the same CRAFT forward but takes the mask from the
    binarised page ink (deterministic boxes without trained weights).
    ``text_threshold`` is applied later, by the keep predicate."""
    del text_threshold
    if cc_stats not in CC_STATS:
        raise ValueError(f"cc_stats must be one of {tuple(CC_STATS)}, got {cc_stats!r}")
    rgb, heat = craft_heatmap(model, pages_u8, allow_tf32)
    with record_function("marie.cc"):
        mask, scores, stride = heat_masks(
            heat, rgb, low_text, link_threshold, model.cfg.out_stride,
            box_source, cc_mask)
        stats = cc_component_stats(mask, scores, max_components, cc_stats, cc_runs)
    stats["stride"] = torch.full((pages_u8.shape[0],), stride, dtype=torch.int32,
                                 device=pages_u8.device)
    return stats


def cc_component_stats(mask: torch.Tensor, scores: torch.Tensor, max_components: int,
                       cc_stats: str = "runs_cc", cc_runs: int = 48) -> Dict[str, torch.Tensor]:
    """[B, h, w] mask and score map -> per-page component stats by the
    ``cc_stats`` variant: ``runs_cc`` on the mask with ``cc_runs`` runs a
    row, the others on :func:`connected_components`' labels (``runs`` at
    its own default budget, as the JAX detector calls it)."""
    fn = CC_STATS[cc_stats]
    if fn is component_boxes_runs_cc:
        return fn(mask, scores, max_components=max_components, max_runs_per_row=cc_runs)
    return fn(connected_components(mask), scores, max_components=max_components)


def is_grayscale(stack: np.ndarray) -> bool:
    """Are all three channels of a [P, H, W, 3] stack equal?  (A sampled
    check, then a full one on a hit, as the JAX package's ``fused.py::
    _is_grayscale`` does.)"""
    if stack.ndim != 4 or stack.shape[-1] != 3:
        return False
    probe = stack[..., ::16, ::16, :]
    if not (np.array_equal(probe[..., 0], probe[..., 1])
            and np.array_equal(probe[..., 0], probe[..., 2])):
        return False
    return bool(np.array_equal(stack[..., 0], stack[..., 1])
                and np.array_equal(stack[..., 0], stack[..., 2]))


def cc_kwargs(bp) -> Dict[str, object]:
    """The keywords of :func:`detect_core` that a :class:`BoxProcessorCraft`
    sets beside its thresholds."""
    return {"cc_stats": bp.cc_stats, "cc_runs": bp.cc_runs, "allow_tf32": bp.allow_tf32}


class BoxProcessorCraft(BoxProcessor):
    """Word detector over the port's CRAFT model (the JAX package's
    ``BoxProcessorCraft``).

    ``variables`` is a flax-layout numpy tree
    (:mod:`marie_tpu_torch.registry.convert`); without one the weights are
    drawn from seed 0.  ``param_dtype="bfloat16"`` casts every float leaf,
    the batch statistics too, as the JAX processor does.  Port-only
    keywords: ``device``; ``cc_stats``, the component stats variant (the
    JAX ``MARIE_CC_STATS``); ``cc_runs``, the run-domain CC's per-row run
    budget (the JAX ``MARIE_CC_RUNS``); ``allow_tf32``, whether float32
    convolutions may run in TF32 (the engine sets this for each forward
    and leaves the global flags as it found them); ``cpu_bf16_rounding``,
    where a bf16 model rounds on the CPU: ``"xla"``, as the JAX package's
    CPU results, or ``"torch"``, as the card (``models/craft.py``)."""

    #: the zoo tree the weights came from (None: passed in or seeded)
    zoo_name: Optional[str] = None

    def __init__(
        self,
        config: Optional[CraftConfig] = None,
        variables=None,
        text_threshold: float = 0.7,
        low_text: float = 0.4,
        link_threshold: float = 0.4,
        min_area: int = 10,
        max_components: int = 1024,
        bucket_spec: Optional[BucketSpec] = None,
        box_source: str = "heatmap",
        box_expand: float = 0.14,
        param_dtype: str = "float32",
        *,
        device="cuda",
        cc_stats: str = "runs_cc",
        cc_runs: int = 48,
        allow_tf32: bool = False,
        cpu_bf16_rounding: str = "xla",
    ):
        if param_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"param_dtype must be float32 or bfloat16, got {param_dtype!r}")
        if box_source not in ("heatmap", "ink"):
            raise ValueError(f"box_source must be 'heatmap' or 'ink', got {box_source!r}")
        if cc_stats not in CC_STATS:
            raise ValueError(f"cc_stats must be one of {tuple(CC_STATS)}, got {cc_stats!r}")
        self.device = resolve_device(device)
        self.config = config or CraftConfig.fast_s2d2()
        self.text_threshold = text_threshold
        self.low_text = low_text
        self.link_threshold = link_threshold
        self.min_area = min_area
        self.max_components = max_components
        self.box_source = box_source
        # heatmap-mode dilation: CRAFT region targets are trained shrunk;
        # ink boxes are exact
        self.box_expand = box_expand if box_source == "heatmap" else 0.0
        self.buckets = bucket_spec or BucketSpec()
        self.cc_stats = cc_stats
        self.cc_runs = cc_runs
        self.allow_tf32 = allow_tf32
        if variables is None:
            variables = init_flax_layout(self.config, 0)
        dtype = torch.bfloat16 if param_dtype == "bfloat16" else torch.float32
        self.model = load_model(self.config, variables, self.device, dtype)
        self.model.set_cpu_bf16_rounding(cpu_bf16_rounding)

    def heatmap(self, pages) -> torch.Tensor:
        """[H, W] / [B, H, W] / [B, H, W, 3] uint8 pages (numpy or
        tensor) -> the CRAFT heatmap [B, h, w, 2] float32 on the processor's device."""
        x = torch.as_tensor(pages).to(self.device)
        if x.ndim == 2:
            x = x[None]
        return craft_heatmap(self.model, x, self.allow_tf32)[1]

    def detect_words(self, image: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        boxes, scores, _, _ = self.detect_with_page(image)
        return boxes, scores

    def detect_with_page(self, image: np.ndarray):
        """Detect AND keep the page on the device for recognition:
        (boxes_xywh [N,4] original coords, scores [N], the bucket-padded
        grayscale page [bh, bw] uint8 on the device, scale)."""
        handle = self.detect_dispatch(image)
        boxes, scores = self.detect_collect(handle)
        return boxes, scores, handle[1], handle[2]

    def prep_page(self, image: np.ndarray):
        """Bucket-fit + pad a page for detection: (padded [bh, bw] or
        [bh, bw, 3] uint8, scale, (h, w)) by :func:`fit_to_bucket`.  A
        [H, W, 4] page loses its fourth channel."""
        if image.dtype != np.uint8 or image.ndim not in (2, 3):
            raise ValueError(f"pages are uint8 [H, W] or [H, W, 3|4], got "
                             f"{image.dtype} {image.shape}")
        if image.ndim == 3:
            image = np_rgb(image)
        return (*fit_to_bucket(image, self.buckets), image.shape[:2])

    def detect_dispatch(self, image: np.ndarray):
        """Phase 1: upload the page and launch detection; the handle
        (device stats, device page, scale, (h, w)) is collected later.
        The device page is [bh, bw] when the page's channels are equal
        (its crops then go through K1), else [bh, bw, 3]."""
        padded, scale, (h, w) = self.prep_page(image)
        if padded.ndim == 3 and is_grayscale(padded[None]):
            padded = padded[..., 0]
        page_dev = torch.from_numpy(np.ascontiguousarray(padded)).to(self.device)
        stats = detect_core(
            self.model, page_dev[None], self.text_threshold, self.low_text,
            self.link_threshold, self.max_components, self.box_source,
            **cc_kwargs(self))
        return ({k: v[0] for k, v in stats.items()}, page_dev, scale, (h, w))

    def detect_collect(self, handle, stats=None, return_rows: bool = False):
        """Phase 2: filter a dispatched detection on the host.

        ``stats`` may be host arrays fetched beforehand (one fetch for
        many pages); otherwise the handle's are fetched here.

        ``return_rows``: also return each surviving box's rank within the
        kept set (ascending slot order) — the fused path decodes boxes in
        exactly this order on the device, so the rank is the decoded-row
        index (``ocr/fused.py``).
        """
        stats_dev, _page_dev, scale, (h, w) = handle
        if stats is None:
            stats = {k: v.cpu().numpy() for k, v in stats_dev.items()}
        boxes = stats["boxes"]  # heatmap grid coords
        scores = stats["scores"]
        areas = stats["areas"]
        valid = stats["valid"]

        stride = float(np.asarray(stats.get("stride", 2)))
        score_floor = 0.0 if self.box_source == "ink" else self.text_threshold
        min_area = self.min_area / (stride / 2.0) ** 2  # area is in grid cells
        keep = valid & (scores >= score_floor) & (areas >= min_area)
        rows = np.arange(int(keep.sum()))  # rank within kept, slot order
        boxes = boxes[keep] * stride / scale  # grid -> padded page -> original
        if self.box_expand > 0 and len(boxes):
            bw = boxes[:, 2] - boxes[:, 0]
            bh = boxes[:, 3] - boxes[:, 1]
            boxes = boxes + np.stack(
                [-bw * self.box_expand, -bh * self.box_expand,
                 bw * self.box_expand, bh * self.box_expand], axis=-1,
            )
        scores = scores[keep]

        # clip to the original page, convert to xywh
        boxes[:, 0] = np.clip(boxes[:, 0], 0, w)
        boxes[:, 1] = np.clip(boxes[:, 1], 0, h)
        boxes[:, 2] = np.clip(boxes[:, 2], 0, w)
        boxes[:, 3] = np.clip(boxes[:, 3], 0, h)
        xywh = np.stack(
            [
                boxes[:, 0],
                boxes[:, 1],
                boxes[:, 2] - boxes[:, 0],
                boxes[:, 3] - boxes[:, 1],
            ],
            axis=-1,
        )
        nonempty = (xywh[:, 2] > 0) & (xywh[:, 3] > 0)
        if return_rows:
            return xywh[nonempty], scores[nonempty], rows[nonempty]
        return xywh[nonempty], scores[nonempty]
