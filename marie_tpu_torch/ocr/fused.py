"""Batched page OCR in one pass over a page group (port of
``marie_tpu/ocr/fused.py``): unpack -> detect -> keep/compact -> crop (K1)
-> TrOCR encode (K2 in every layer) and greedy decode.

Row alignment contract (as in the JAX package): the device keeps boxes
with ``valid & score >= floor & area >= min_area`` on real pages and
decodes them page-major, slot-ascending; the host applies the same
predicate to the fetched stats, so page p's j-th kept box is decoded row
(kept boxes of pages < p) + j.
"""

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.profiler import record_function

from marie_tpu_torch.boxes.craft_box_processor import detect_core
from marie_tpu_torch.models.trocr import greedy_decode
from marie_tpu_torch.ops.kernels.crop_resize import crop_resize
from marie_tpu_torch.preprocess.ops import fma


def _geometric_step_caps(eff_w: torch.Tensor, out_h: int, max_steps: int) -> torch.Tensor:
    """Per-row decode budget from crop geometry: a glyph is ~out_h/2 px
    wide after height normalization, so eff_w bounds the character count
    (+4 slack for thin glyphs and the EOS step)."""
    glyph_w = max(out_h // 2, 1)
    caps = torch.div(eff_w.to(torch.int32), glyph_w, rounding_mode="floor") + 4
    return torch.clamp(caps, 6, max_steps).to(torch.int32)


def _unpack4(packed_u8: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack4``: [..., W//2] nibbles -> [..., W] uint8
    (nibble * 17), high nibble first."""
    rep = torch.repeat_interleave(packed_u8, 2, dim=-1)
    col = torch.arange(rep.shape[-1], device=rep.device)
    nib = torch.where(col % 2 == 0, rep >> 4, rep & 0xF)
    return nib * 17


def _unpack2(packed_u8: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack2``: [..., W//4] 2-bit quads -> [..., W] uint8
    (level * 85), most significant pair first."""
    rep = torch.repeat_interleave(packed_u8, 4, dim=-1).to(torch.int32)
    col = torch.arange(rep.shape[-1], device=rep.device)
    lvl = (rep >> ((3 - col % 4) * 2)) & 0x3
    return (lvl * 85).to(torch.uint8)


def _unpack1(packed_u8: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack1``: [..., W//8] bits -> [..., W] uint8
    (bit * 255), most significant bit first."""
    rep = torch.repeat_interleave(packed_u8, 8, dim=-1).to(torch.int32)
    col = torch.arange(rep.shape[-1], device=rep.device)
    bit = (rep >> (7 - col % 8)) & 0x1
    return (bit * 255).to(torch.uint8)


def _norm_pack_bits(packed) -> int:
    """False/None -> 0 (unpacked), True -> 4, else 1, 2 or 4."""
    if packed is True:
        return 4
    if not packed:
        return 0
    bits = int(packed)
    if bits not in (1, 2, 4):
        raise ValueError(f"pack bits must be 1, 2 or 4, got {packed!r}")
    return bits


def _unpack_bits(pages_u8: torch.Tensor, bits: int) -> torch.Tensor:
    if bits == 4:
        return _unpack4(pages_u8)
    if bits == 2:
        return _unpack2(pages_u8)
    if bits == 1:
        return _unpack1(pages_u8)
    return pages_u8


def keep_predicate(stats: Dict[str, torch.Tensor], box_source: str,
                   text_threshold: float, min_area: float) -> torch.Tensor:
    """[P, M] bool: valid & score >= floor & area >= min_area (in grid
    cells), compared in float32 as the device program does."""
    stride = stats["stride"][0].to(torch.float32)
    score_floor = 0.0 if box_source == "ink" else text_threshold
    min_area_grid = torch.tensor(min_area, dtype=torch.float32,
                                 device=stride.device) / (stride / 2.0) ** 2
    return (
        stats["valid"]
        & (stats["scores"] >= score_floor)
        & (stats["areas"].to(torch.float32) >= min_area_grid)
    )


@torch.no_grad()
def fused_pages_compact(
    craft_model: nn.Module,
    trocr_model: nn.Module,
    pages_u8: torch.Tensor,  # [P, H, W] uint8 (or packed [P, H, W*bits/8])
    clip_whs: torch.Tensor,  # [P, 2] float32 crop clip (w, h)
    n_real: int,  # pages before ladder padding
    text_threshold: float,
    low_text: float,
    link_threshold: float,
    min_area: float,
    box_expand: float,
    max_components: int,
    box_source: str,
    total_slots: int,
    out_h: int,
    out_w: int,
    dtype: torch.dtype,
    max_steps: int,
    packed: int = 0,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor,
           Tuple[torch.Tensor, torch.Tensor]]:
    """Page-batched OCR with GLOBAL crop compaction: the kept boxes of all
    real pages fill one cross-page crop batch of ``total_slots`` rows
    (kept first, page-major then slot-ascending); ladder-padding pages
    (index >= ``n_real``) are excluded.  Crops always go through K1.

    Returns (stats, tokens [T, max_steps] int32, conf [T] float32,
    (crop boxes [P*M, 4] float32 padded-page xyxy, page_of [P*M] int32)):
    the last pair holds every row in compaction order, so kept rows past
    ``total_slots`` can be cropped later with the same boxes."""
    pages_u8 = _unpack_bits(pages_u8, _norm_pack_bits(packed))
    if pages_u8.ndim != 3:
        raise ValueError("fused_pages_compact takes grayscale [P, H, W] pages")
    dev = pages_u8.device
    p = pages_u8.shape[0]
    stats = detect_core(craft_model, pages_u8, text_threshold, low_text,
                        link_threshold, max_components, box_source)
    m = stats["boxes"].shape[1]
    stride = stats["stride"][0].to(torch.float32)
    keep = keep_predicate(stats, box_source, text_threshold, min_area)
    keep = keep & (torch.arange(p, device=dev)[:, None] < n_real)

    flat_keep = keep.reshape(-1)
    gid = torch.arange(p * m, device=dev)
    order = torch.argsort(torch.where(flat_keep, gid, p * m + gid), stable=True)
    page_of = torch.div(order, m, rounding_mode="floor").to(torch.int32)

    b = stats["boxes"].reshape(p * m, 4)[order].to(torch.float32) * stride
    bw = b[:, 2] - b[:, 0]
    bh = b[:, 3] - b[:, 1]
    b = fma(torch.stack([-bw, -bh, bw, bh], dim=-1),
            torch.tensor(box_expand, dtype=torch.float32, device=dev), b)
    clip = clip_whs.to(device=dev, dtype=torch.float32)[page_of.long()]
    hi = torch.stack([clip[:, 0], clip[:, 1], clip[:, 0], clip[:, 1]], dim=-1)
    b = torch.minimum(torch.clamp(b, min=0.0), hi)
    b = torch.where(flat_keep[order][:, None], b,
                    torch.tensor([0.0, 0.0, 1.0, 1.0], device=dev))

    sel_keep = flat_keep[order[:total_slots]]
    with record_function("marie.crop"):
        crops, eff_w = crop_resize(pages_u8, page_of[:total_slots],
                                   b[:total_slots], out_h, out_w)
        crops = crops[..., None].expand(*crops.shape, 3)
    tokens, _, conf = greedy_decode(
        trocr_model, crops.to(dtype), max_steps, active=sel_keep,
        step_caps=_geometric_step_caps(eff_w, out_h, max_steps))
    return stats, tokens, conf, (b, page_of)


def host_keep_rows(stats_np: Dict[str, np.ndarray], box_source: str,
                   text_threshold: float, min_area: float) -> np.ndarray:
    """Host replica of :func:`keep_predicate` for one page's fetched stats
    (float32 compares, as on the device)."""
    stride = float(np.asarray(stats_np["stride"]))
    floor = np.float32(0.0 if box_source == "ink" else text_threshold)
    area_floor = np.float32(min_area) / np.float32(stride / 2.0) ** 2
    return (
        np.asarray(stats_np["valid"])
        & (np.asarray(stats_np["scores"], np.float32) >= floor)
        & (np.asarray(stats_np["areas"], np.float32) >= area_floor)
    )
