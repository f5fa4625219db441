"""CRAFT detection core (port of
``marie_tpu/boxes/craft_box_processor.py::_detect_core``): batched pages ->
fixed-size per-page component stats.

The JAX version reads ``MARIE_CC_STATS``, ``MARIE_CC_MASK`` and
``MARIE_CC_RUNS`` from the environment while it traces; here they are the
keyword arguments ``cc_stats``, ``cc_mask`` and ``cc_runs`` with the same
defaults.  Only the ``runs_cc`` stats variant is ported.
"""

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from marie_tpu_torch.ops.connected_components import component_boxes_runs_cc
from marie_tpu_torch.preprocess.ops import normalize_page, otsu_binarize, to_grayscale

CC_STATS = ("runs_cc",)
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
) -> Dict[str, torch.Tensor]:
    """Batched pages -> per-page component stats (boxes on the heatmap
    grid, areas, scores, valid, and the grid ``stride``).

    ``box_source="heatmap"`` masks the CRAFT region map at ``low_text``;
    ``"ink"`` runs the same CRAFT forward but takes the mask from the
    binarised page ink (deterministic boxes without trained weights).
    ``text_threshold`` is applied later, by the keep predicate."""
    del text_threshold
    if cc_stats not in CC_STATS:
        raise NotImplementedError(
            f"cc_stats={cc_stats!r}: only {CC_STATS} is ported")
    if pages_u8.ndim == 3:
        pages_u8 = pages_u8[..., None].expand(*pages_u8.shape, 3)
    with record_function("marie.detect"):
        rgb = normalize_page(pages_u8)
        pdt = next(model.parameters()).dtype
        heat = model(rgb.to(pdt)).to(torch.float32)
    with record_function("marie.cc"):
        mask, scores, stride = heat_masks(
            heat, rgb, low_text, link_threshold, model.cfg.out_stride,
            box_source, cc_mask)
        stats = component_boxes_runs_cc(
            mask, scores, max_components=max_components, max_runs_per_row=cc_runs)
    stats["stride"] = torch.full((pages_u8.shape[0],), stride, dtype=torch.int32,
                                 device=pages_u8.device)
    return stats
