"""Batched page OCR (port of ``marie_tpu/ocr/fused.py``): one pass over a
page group — unpack -> detect -> keep/compact -> crop (K1) -> TrOCR encode
(K2 in every layer) and greedy decode — and the serving pipeline around
it: host prep and packed uploads on a worker thread, the device program,
and the host collect, streamed group by group so the three overlap.

A group whose pages all have equal channels uploads them as a grayscale
[P, H, W] stack (packed for the ``u4``/``u2``/``u1``/``u1d`` formats) and
crops them with K1; a group of RGB pages with distinct channels uploads
[P, H, W, 3] uint8 and crops them with stock ops, as the JAX package does
(its Pallas crop takes grayscale stacks only).

Row alignment contract (as in the JAX package): the device keeps boxes
with ``valid & score >= floor & area >= min_area`` on real pages and
decodes them page-major, slot-ascending; the host applies the same
predicate to the fetched stats (``detect_collect(return_rows=True)``,
:func:`_kept_count`), so page p's j-th kept box is decoded row
(kept boxes of pages < p) + j.  Kept boxes past the group's row budget
are recognised on collect through ``TrOcrProcessor.recognize_dispatch``,
as the JAX engine does.

The per-page programs (:func:`fused_page`, :func:`fused_pages`: a fixed
``rec_slots`` rows a page, kept slots first in slot order) are the JAX
package's ``_fused_page`` / ``_fused_pages``: :func:`fused_dispatch`
runs one page through them and :func:`fused_collect_many` collects their
``"s"`` / ``"g"`` handles beside the groups'.  Their kernels count on the
``"single"`` launch path.
"""

import copy
import queue
import threading
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.profiler import record_function

from marie_tpu_torch.boxes.craft_box_processor import cc_kwargs, detect_core, is_grayscale
from marie_tpu_torch.models.trocr import greedy_decode
from marie_tpu_torch.ops.kernels._build import launch_path
from marie_tpu_torch.ops.kernels.crop_resize import crop_resize
from marie_tpu_torch.preprocess.ops import crop_resize_pages, fma
from marie_tpu_torch.utils.device import resolve_mesh
from marie_tpu_torch.utils.pack4 import PACKERS

UPLOAD_FORMATS = ("u8",) + tuple(PACKERS)


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


def _rows_and_decode(pages_u8, trocr_model, boxes, stride, row_keep, page_of, clip,
                     box_expand, out_h, out_w, dtype, max_steps, active):
    """The selected rows' boxes (grid cells, [N, 4]) -> expanded by
    ``box_expand``, clipped to their page's ``clip`` (w, h), [0, 0, 1, 1]
    where ``row_keep`` is False -> crops (K1 for a grayscale stack, stock
    ops for RGB) -> greedy decode with the geometric step caps (rows not
    ``active`` start finished).  Returns (tokens, conf, boxes)."""
    dev = pages_u8.device
    b = boxes.to(torch.float32) * stride
    bw = b[:, 2] - b[:, 0]
    bh = b[:, 3] - b[:, 1]
    b = fma(torch.stack([-bw, -bh, bw, bh], dim=-1),
            torch.tensor(box_expand, dtype=torch.float32, device=dev), b)
    hi = torch.stack([clip[:, 0], clip[:, 1], clip[:, 0], clip[:, 1]], dim=-1)
    b = torch.minimum(torch.clamp(b, min=0.0), hi)
    b = torch.where(row_keep[:, None], b, torch.tensor([0.0, 0.0, 1.0, 1.0], device=dev))
    with record_function("marie.crop"):
        if pages_u8.ndim == 3:
            crops, eff_w = crop_resize(pages_u8, page_of, b, out_h, out_w)
            crops = crops[..., None].expand(*crops.shape, 3)
        else:
            crops, eff_w = crop_resize_pages(pages_u8, page_of, b, out_h, out_w)
    tokens, _, conf = greedy_decode(
        trocr_model, crops.to(dtype), max_steps, active=active,
        step_caps=_geometric_step_caps(eff_w, out_h, max_steps))
    return tokens, conf, b


def _detect_keep(craft_model, pages_u8, packed, page0: int, n_real: int, text_threshold,
                 low_text, link_threshold, min_area, max_components, box_source, cc_stats,
                 cc_runs, allow_tf32):
    """The page-local stages of :func:`compact_program` on pages ``page0``
    onwards of a batch: unpack, detect, connected components and the
    keep predicate (ladder-padding pages, index >= ``n_real``, keep
    nothing).  Returns (pages unpacked, stats, keep [P, M])."""
    pages_u8 = _unpack_bits(pages_u8, _norm_pack_bits(packed))
    if pages_u8.ndim not in (3, 4):
        raise ValueError("the page program takes [P, H, W] or [P, H, W, 3] pages")
    stats = detect_core(craft_model, pages_u8, text_threshold, low_text, link_threshold,
                        max_components, box_source, cc_stats=cc_stats, cc_runs=cc_runs,
                        allow_tf32=allow_tf32)
    keep = keep_predicate(stats, box_source, text_threshold, min_area)
    page = torch.arange(page0, page0 + pages_u8.shape[0], device=pages_u8.device)
    return pages_u8, stats, keep & (page[:, None] < n_real)


def _compact_order(keep: torch.Tensor, total_slots: int):
    """The global compaction: (order [T] of flat (page, slot) ids, kept
    first, page-major then slot-ascending; page_of [T] int32; keep of each
    row [T])."""
    p, m = keep.shape
    flat_keep = keep.reshape(-1)
    gid = torch.arange(p * m, device=keep.device)
    order = torch.argsort(torch.where(flat_keep, gid, p * m + gid), stable=True)[:total_slots]
    page_of = torch.div(order, m, rounding_mode="floor").to(torch.int32)
    return order, page_of, flat_keep[order]


@torch.no_grad()
def compact_program(
    craft_model: nn.Module,
    trocr_model: nn.Module,
    pages_u8: torch.Tensor,  # [P, H, W] / [P, H, W, 3] uint8 (or packed [P, H, W*bits/8])
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
    cc_stats: str = "runs_cc",
    cc_runs: int = 48,
    allow_tf32: bool = False,
):
    """Page-batched OCR with GLOBAL crop compaction: the kept boxes of all
    real pages fill one cross-page crop batch of ``total_slots`` rows
    (kept first, page-major then slot-ascending); ladder-padding pages
    (index >= ``n_real``) are excluded.  Grayscale crops go through K1,
    RGB crops through stock ops.

    Returns (stats, tokens [T, max_steps] int32, conf [T] float32, rows)
    with what the chained heads read, rows = (keep [P, M] bool, boxes
    [T, 4] float32 xyxy page pixels, clip [T, 2] of each row's page)."""
    pages_u8, stats, keep = _detect_keep(
        craft_model, pages_u8, packed, 0, n_real, text_threshold, low_text, link_threshold,
        min_area, max_components, box_source, cc_stats, cc_runs, allow_tf32)
    p, m = keep.shape
    stride = stats["stride"][0].to(torch.float32)
    order, page_of, sel_keep = _compact_order(keep, total_slots)
    clip = clip_whs.to(device=pages_u8.device, dtype=torch.float32)[page_of.long()]
    tokens, conf, b = _rows_and_decode(
        pages_u8, trocr_model, stats["boxes"].reshape(p * m, 4)[order], stride, sel_keep,
        page_of, clip, box_expand, out_h, out_w, dtype, max_steps, active=sel_keep)
    return stats, tokens, conf, (keep, b, clip)


@torch.no_grad()
def mesh_compact_program(mesh, craft_models, trocr_models, pages_u8: torch.Tensor,
                         clip_whs: torch.Tensor, n_real: int, text_threshold, low_text,
                         link_threshold, min_area, box_expand, max_components, box_source,
                         total_slots, out_h, out_w, dtype, max_steps, packed: int = 0,
                         cc_stats: str = "runs_cc", cc_runs: int = 48,
                         allow_tf32: bool = False):
    """:func:`compact_program` over a local mesh, with the same result.

    The page batch splits into one block of consecutive pages per mesh
    entry (``craft_models[i]`` / ``trocr_models[i]`` are entry i's
    copies).  Each entry runs the page-local stages on its block (unpack,
    detector, CC, keep); the keep masks and stats are gathered on the
    batch's device, where the compaction's order comes from the whole
    keep mask, as unsharded; each entry then crops (K1) and decodes the
    rows of its own pages, and the rows are put back in the compacted
    order.  Returns what :func:`compact_program` returns, on the batch's
    device."""
    devs = mesh.local_devices
    n, p = len(devs), int(pages_u8.shape[0])
    if p % n:
        raise ValueError(f"page batch {p} not divisible by mesh devices {n}")
    per, home = p // n, pages_u8.device

    def page_stages(i, dev):
        return _detect_keep(craft_models[i], pages_u8[i * per:(i + 1) * per].to(dev), packed,
                            i * per, n_real, text_threshold, low_text, link_threshold,
                            min_area, max_components, box_source, cc_stats, cc_runs,
                            allow_tf32)

    parts = mesh.run_each(page_stages)
    stats = {k: torch.cat([part[1][k].to(home) for part in parts]) for k in parts[0][1]}
    keep = torch.cat([part[2].to(home) for part in parts])
    m = keep.shape[1]
    stride = stats["stride"][0].to(torch.float32)
    order, page_of, sel_keep = _compact_order(keep, total_slots)
    clip = clip_whs.to(device=home, dtype=torch.float32)[page_of.long()]
    boxes = stats["boxes"].reshape(p * m, 4)[order]
    owner = torch.div(page_of, per, rounding_mode="floor")
    rows = [torch.nonzero(owner == i)[:, 0] for i in range(n)]

    def shard_rows(i, dev):
        r = rows[i]
        if r.numel() == 0:
            return None
        keep_r = sel_keep[r].to(dev)
        return _rows_and_decode(
            parts[i][0], trocr_models[i], boxes[r].to(dev), stride.to(dev), keep_r,
            (page_of[r] - i * per).to(dev), clip[r].to(dev), box_expand, out_h, out_w, dtype,
            max_steps, active=keep_r)

    outs = mesh.run_each(shard_rows)
    done = [(r, o) for r, o in zip(rows, outs) if o is not None]
    t, steps = order.shape[0], done[0][1][0].shape[1]
    tokens = torch.empty((t, steps), dtype=torch.int32, device=home)
    conf = torch.empty((t,), dtype=torch.float32, device=home)
    b = torch.empty((t, 4), dtype=torch.float32, device=home)
    for r, (tok, cf, bx) in done:
        tokens[r], conf[r], b[r] = tok.to(home), cf.to(home), bx.to(home)
    return stats, tokens, conf, (keep, b, clip)


def mesh_models(processor, mesh, attr: str = "model") -> List[nn.Module]:
    """A processor's model replicated once per local mesh, one per entry
    (cached on the processor by the mesh's devices, as the JAX package
    caches its replicated trees): entries on the model's own device share
    it, every other device gets one copy."""
    cache = processor.__dict__.setdefault("_mesh_model_cache", {})
    key = (attr, tuple(str(d) for d in mesh.local_devices))
    if key not in cache:
        base = getattr(processor, attr)
        own = next(base.parameters()).device
        copies: Dict[str, nn.Module] = {str(own): base}
        for dev in mesh.local_devices:
            if str(dev) not in copies:
                copies[str(dev)] = copy.deepcopy(base).to(dev)
        cache[key] = [copies[str(dev)] for dev in mesh.local_devices]
    return cache[key]


def fused_pages_compact(*args, **kwargs) -> Tuple[Dict[str, torch.Tensor], torch.Tensor,
                                                  torch.Tensor]:
    """:func:`compact_program` (same arguments) -> (stats, tokens, conf)."""
    return compact_program(*args, **kwargs)[:3]


def program_args(bp, op, total_slots: int) -> tuple:
    """The settings of the two processors in :func:`compact_program`'s
    argument order, from ``text_threshold`` to ``max_steps``."""
    return (bp.text_threshold, bp.low_text, bp.link_threshold, float(bp.min_area),
            float(bp.box_expand), bp.max_components, bp.box_source, int(total_slots),
            op.crop_h, op.crop_w, op.compute_dtype, op.decode_steps)


@torch.no_grad()
def pages_program(
    craft_model: nn.Module,
    trocr_model: nn.Module,
    pages_u8: torch.Tensor,  # [P, H, W] / [P, H, W, 3] uint8, same bucket
    clip_whs: torch.Tensor,  # [P, 2] float32 crop clip (w, h)
    text_threshold: float,
    low_text: float,
    link_threshold: float,
    min_area: float,
    box_expand: float,
    max_components: int,
    box_source: str,
    rec_slots: int,
    out_h: int,
    out_w: int,
    dtype: torch.dtype,
    max_steps: int,
    active_rows: bool = True,
    cc_stats: str = "runs_cc",
    cc_runs: int = 48,
    allow_tf32: bool = False,
):
    """Per-page OCR: ``rec_slots`` recognition rows a page (kept slots
    first, in slot order; the rest crop the box [0, 0, 1, 1]).  With
    ``active_rows`` the rows that hold no kept box start finished in the
    decode (``_fused_pages``); without, every row decodes
    (``_fused_page``).  Grayscale crops go through K1, RGB crops through
    stock ops.

    Returns (stats, tokens [P, R, max_steps] int32, conf [P, R] float32)
    with R = min(rec_slots, the stats' component slots)."""
    if pages_u8.ndim not in (3, 4):
        raise ValueError("the page program takes [P, H, W] or [P, H, W, 3] pages")
    dev = pages_u8.device
    p = pages_u8.shape[0]
    stats = detect_core(craft_model, pages_u8, text_threshold, low_text,
                        link_threshold, max_components, box_source,
                        cc_stats=cc_stats, cc_runs=cc_runs, allow_tf32=allow_tf32)
    m = stats["boxes"].shape[1]
    stride = stats["stride"][0].to(torch.float32)
    keep = keep_predicate(stats, box_source, text_threshold, min_area)
    slot = torch.arange(m, device=dev)
    sel = torch.argsort(torch.where(keep, slot, m + slot), dim=1, stable=True)[:, :rec_slots]
    r = sel.shape[1]
    sel_keep = torch.gather(keep, 1, sel).reshape(-1)
    boxes = torch.gather(stats["boxes"], 1, sel[..., None].expand(p, r, 4)).reshape(p * r, 4)
    clip = clip_whs.to(device=dev, dtype=torch.float32).repeat_interleave(r, dim=0)
    page_of = torch.arange(p, device=dev, dtype=torch.int32).repeat_interleave(r)
    tokens, conf, _ = _rows_and_decode(
        pages_u8, trocr_model, boxes, stride, sel_keep, page_of, clip, box_expand, out_h,
        out_w, dtype, max_steps, active=sel_keep if active_rows else None)
    return stats, tokens.reshape(p, r, -1), conf.reshape(p, r)


def fused_page(craft_model, trocr_model, page_u8: torch.Tensor, clip_wh: torch.Tensor,
               *args, **kwargs):
    """One page ([H, W] grayscale or [H, W, 3] uint8, bucket-padded; clip
    [2]) through :func:`pages_program` with every row decoding, as the
    JAX package's ``_fused_page``: (stats of the page, tokens [R,
    max_steps], conf [R]).  ``args`` are :func:`pages_program`'s from
    ``text_threshold`` to ``max_steps``."""
    stats, tokens, conf = pages_program(craft_model, trocr_model, page_u8[None],
                                        clip_wh.reshape(1, 2), *args, active_rows=False,
                                        **kwargs)
    return {k: v[0] for k, v in stats.items()}, tokens[0], conf[0]


def fused_pages(craft_model, trocr_model, pages_u8: torch.Tensor, clip_whs: torch.Tensor,
                *args, **kwargs):
    """Page-batched :func:`pages_program` (the JAX package's
    ``_fused_pages``): the rows that hold no kept box start finished."""
    return pages_program(craft_model, trocr_model, pages_u8, clip_whs, *args,
                         active_rows=True, **kwargs)


class PageHandle(NamedTuple):
    """A dispatch of the per-page programs: ``kind`` ``"s"`` (one page:
    ``stats`` of the page, ``tokens`` [R, S], ``conf`` [R], ``pages`` the
    device page) or ``"g"`` (a page batch: leading page dimension
    everywhere).  ``stats``, ``tokens`` and ``conf`` are host tensors
    whose copies from the card complete at ``ready`` (None on the CPU);
    ``metas`` is (scale, (h, w)) per page."""

    kind: str
    stats: Dict[str, torch.Tensor]
    tokens: torch.Tensor
    conf: torch.Tensor
    pages: torch.Tensor
    metas: List[Tuple[float, Tuple[int, int]]]
    rec_slots: int
    ready: Optional[Any]


def _page_handle(kind, device, stats, tokens, conf, pages, metas, rec_slots) -> PageHandle:
    """Copy a program's outputs to pinned host buffers behind an event."""
    stats = {k: _to_host(v) for k, v in stats.items()}
    tokens, conf = _to_host(tokens), _to_host(conf)
    ready = None
    if device.type == "cuda":
        ready = torch.cuda.Event()
        ready.record()
    return PageHandle(kind, stats, tokens, conf, pages, metas, int(rec_slots), ready)


def _dispatch_prepped(bp, op, padded: np.ndarray, scale: float, hw, rec_slots: int) -> PageHandle:
    """Upload a prepped page (channel-free when its channels are equal)
    and run :func:`fused_page` on it under the ``"single"`` launch path."""
    if padded.ndim == 3 and is_grayscale(padded[None]):
        padded = padded[..., 0]
    page_dev = _to_device(padded, bp.device)
    h, w = hw
    clip_wh = torch.tensor([w * scale, h * scale], dtype=torch.float32, device=bp.device)
    with launch_path("single"):
        stats, tokens, conf = fused_page(
            bp.model, op.model, page_dev, clip_wh, *program_args(bp, op, rec_slots),
            **cc_kwargs(bp))
    return _page_handle("s", bp.device, stats, tokens, conf, page_dev,
                        [(scale, (h, w))], rec_slots)


def fused_dispatch(box_processor, ocr_processor, image: np.ndarray,
                   rec_slots: int = 256) -> PageHandle:
    """Upload one page and run the single-page program on it; collect the
    ``"s"`` handle with :func:`fused_collect_many`."""
    bp, op = box_processor, ocr_processor
    padded, scale, (h, w) = bp.prep_page(image)
    return _dispatch_prepped(bp, op, padded, scale, (h, w), rec_slots)


def fused_ocr_pages(
    box_processor,
    ocr_processor,
    pages,
    clip_whs=None,
    *,
    n_real: Optional[int] = None,
    total_slots: Optional[int] = None,
    compact_slots: int = 192,
    mesh=None,
    packed=False,
):
    """Detect + select + crop + decode one same-bucket page batch with the
    thresholds and decode settings of the two processors.

    Args:
      pages: [P, H, W] or [P, H, W, 3] uint8 (numpy or tensor); with
        ``packed`` (4, 2 or 1 bits) the grayscale stack
        :mod:`marie_tpu_torch.utils.pack4` packed.
      clip_whs: [P, 2] float32 crop clip (w, h) per page; defaults to the
        full page extent.
      n_real: pages before ladder padding (defaults to P).
      total_slots: the group's recognition-row budget (defaults to
        ``P * compact_slots``).

    Returns (stats, tokens, conf) on the device (row alignment contract
    in the module docstring).

    ``mesh``: a local :class:`~marie_tpu_torch.parallel.mesh.Mesh` (or
    ``"local"``, see :func:`~marie_tpu_torch.utils.device.resolve_mesh`):
    the page batch splits over its entries and both models are
    replicated once per mesh (:func:`mesh_compact_program`); the batch
    must divide by the entry count.  The result equals the call without
    a mesh."""
    bp, op = box_processor, ocr_processor
    mesh = resolve_mesh(mesh, bp.device)
    pack_bits = _norm_pack_bits(packed)
    p = int(pages.shape[0])
    if mesh is not None and p % mesh.size:
        raise ValueError(f"page batch {p} not divisible by mesh devices {mesh.size}")
    if clip_whs is None:
        h = int(pages.shape[1])
        w = int(pages.shape[2]) * (8 // pack_bits if pack_bits else 1)
        clip_whs = np.tile(np.asarray([[w, h]], np.float32), (p, 1))
    pages = torch.as_tensor(pages).to(bp.device)
    clip_whs = torch.as_tensor(clip_whs, dtype=torch.float32).to(bp.device)
    total_slots = p * compact_slots if total_slots is None else total_slots
    n_real = p if n_real is None else int(n_real)
    with launch_path("fused"):
        if mesh is not None:
            return mesh_compact_program(
                mesh, mesh_models(bp, mesh), mesh_models(op, mesh), pages, clip_whs, n_real,
                *program_args(bp, op, total_slots), packed=pack_bits, **cc_kwargs(bp))[:3]
        return fused_pages_compact(
            bp.model, op.model, pages, clip_whs, n_real,
            *program_args(bp, op, total_slots),
            packed=pack_bits, **cc_kwargs(bp))


def supports_fused_page(box_processor, ocr_processor) -> bool:
    """Duck-typed gate: CRAFT-style detector + greedy TrOCR recogniser."""
    return (
        hasattr(box_processor, "prep_page")
        and hasattr(box_processor, "detect_collect")
        and hasattr(ocr_processor, "tokenizer")
        and hasattr(ocr_processor, "decode_steps")
        and getattr(ocr_processor, "beam_size", 0) == 1
    )


def _ladder_size(n: int, cap: int) -> int:
    """Smallest power of two >= n, capped: few distinct batch shapes."""
    s = 1
    while s < n and s < cap:
        s *= 2
    return min(s, cap)


def _plan_groups(preps, page_batch: int) -> List[List[int]]:
    """Split the prepped page list into same-bucket runs of <= page_batch."""
    groups: List[List[int]] = []
    i = 0
    while i < len(preps):
        bucket = preps[i][0].shape
        group = [i]
        while (
            i + len(group) < len(preps)
            and preps[i + len(group)][0].shape == bucket
            and len(group) < page_batch
        ):
            group.append(i + len(group))
        groups.append(group)
        i += len(group)
    return groups


def _to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> device tensor; to a card through a pinned buffer with
    an asynchronous copy (torch keeps the buffer until the copy is done)."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """Device tensor -> host tensor; from a card into a pinned buffer with
    an asynchronous copy, complete once the stream passes it."""
    if t.device.type == "cpu":
        return t
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return out.copy_(t, non_blocking=True)


def _upload_group(preps, group, page_batch, upload_format: str = "u8",
                  device: torch.device = torch.device("cpu")):
    """Host prep + device upload of one group (on the uploader thread):
    ladder-pad the stack, drop the channels of a stack whose channels are
    all equal, pack a grayscale stack for the ``u4`` / ``u2`` / ``u1`` /
    ``u1d`` formats where the page width allows, and copy it to the
    device.  Returns (pages, clip [P, 2], psize, packed
    bits or 0)."""
    psize = _ladder_size(len(group), page_batch)
    rows = group + [group[-1]] * (psize - len(group))
    with record_function("marie.upload"):
        stack = np.stack([preps[k][0] for k in rows])
        if is_grayscale(stack):
            stack = stack[..., 0]
        packed = 0
        if upload_format in PACKERS and stack.ndim == 3:
            packer, bits = PACKERS[upload_format]
            if stack.shape[-1] % (8 // bits) == 0:
                stack, packed = packer(stack), bits
        clip = np.asarray(
            [[preps[k][2][1] * preps[k][1], preps[k][2][0] * preps[k][1]] for k in rows],
            np.float32,
        )
        return _to_device(stack, device), _to_device(clip, device), psize, packed


class GroupHandle(NamedTuple):
    """One dispatched page group.  ``stats``, ``tokens`` and ``conf`` are
    host tensors whose copies from the card complete at ``ready``, a
    timing event (None on the CPU); ``pages`` is the uploaded stack, packed to ``packed``
    bits (0: not packed), kept for the overflow rows' crops; ``metas`` is
    (scale, (h, w)) per real page.  ``heads``: with chained heads, the
    host tensors (cls_logits, ner_labels, ner_scores), else None."""

    stats: Dict[str, torch.Tensor]
    tokens: torch.Tensor
    conf: torch.Tensor
    pages: torch.Tensor
    packed: int
    metas: List[Tuple[float, Tuple[int, int]]]
    total_slots: int
    ready: Optional[Any]
    heads: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None


class _Stream:
    """One stream's work for :class:`_DeviceThread`: its groups, the
    queue its consumer reads and the consumer's room for handles.  A
    group takes a slot before it runs and gives it back when its consumer
    takes its handle; there are ``max_in_flight + 1`` slots, so the
    stream runs as far ahead as a thread of its own that ran a group and
    then waited for room among ``max_in_flight`` handles."""

    def __init__(self, groups, run_group, max_in_flight: int):
        self.groups = iter(groups)
        self.run_group = run_group  # group -> handle
        self.q: "queue.SimpleQueue" = queue.SimpleQueue()
        self.slots = threading.Semaphore(max(max_in_flight, 1) + 1)  # groups run, not taken
        self.closed = False  # the consumer stopped reading

    def step(self) -> bool:
        """Run the next group into the queue; False once the stream has
        ended (or failed: the error goes to the consumer)."""
        try:
            group = next(self.groups, None)
            if group is None:
                self.q.put(("end", None))
                return False
            self.q.put(("ok", self.run_group(group)))
            return True
        except BaseException as exc:  # noqa: BLE001 — raised in the consumer
            self.q.put(("err", exc))
            return False


class _DeviceThread:
    """The one thread that uploads and runs every stream's page groups,
    kept for the life of the process: cuDNN and cuBLAS keep their plans
    and handles per thread, and a fresh thread rebuilds them (~90 ms of
    host time for the serving CRAFT alone on an H100, seconds for the
    whole engine under several requests at once).  Concurrent streams
    take turns, a group at a time, among those whose consumer has room
    for another handle, so no stream waits for another's consumer.  The
    thread starts when the first stream runs."""

    def __init__(self):
        self._cond = threading.Condition()
        self._streams: List[_Stream] = []
        self._thread: Optional[threading.Thread] = None

    def add(self, stream: _Stream) -> None:
        with self._cond:
            self._streams.append(stream)
            if self._thread is None:
                self._thread = threading.Thread(target=self._serve, daemon=True,
                                                name="fused-upload")
                self._thread.start()
            self._cond.notify()

    def wake(self) -> None:
        """A consumer took a handle, or stopped reading."""
        with self._cond:
            self._cond.notify()

    def _next(self) -> _Stream:
        """The first stream with room for a handle, taken off the list
        (waiting for one); streams whose consumer left are dropped."""
        with self._cond:
            while True:
                self._streams = [st for st in self._streams if not st.closed]
                for i, st in enumerate(self._streams):
                    if st.slots.acquire(blocking=False):
                        return self._streams.pop(i)
                self._cond.wait()

    def _serve(self) -> None:
        while True:
            stream = self._next()
            if stream.step():
                with self._cond:
                    self._streams.append(stream)  # to the back: turns


# process-wide, as the per-thread caches it keeps warm are
_DEVICE = _DeviceThread()

#: stream groups run with a mesh: split over it, or whole because their
#: padded size does not divide by its entry count
MESH_GROUPS: Dict[str, int] = {"sharded": 0, "unsharded": 0}
_MESH_GROUPS_LOCK = threading.Lock()


def _count_group(kind: str) -> None:
    with _MESH_GROUPS_LOCK:
        MESH_GROUPS[kind] += 1


def fused_dispatch_stream(box_processor, ocr_processor, images,
                          rec_slots: int = 256, page_batch: int = 4,
                          compact_slots: int = 192, max_in_flight: int = 4,
                          upload_format: str = "u8", mesh=None, chain=None):
    """Dispatch fused OCR for many pages, YIELDING one :class:`GroupHandle`
    per upload group as soon as its program is in flight.

    Each group of ``psize`` (ladder-padded) pages shares ``psize *
    compact_slots`` recognition rows: pages over the average borrow rows
    from pages under it, and rows past the budget are recognised on
    collect.  ``rec_slots`` is accepted for the JAX API and unused there
    too (single pages take the same program at psize 1).

    Upload, launch and the copies of each group's results into pinned
    host buffers run on the device thread that every stream shares (see
    :class:`_DeviceThread`); the caller collects each handle while later
    groups upload and run.  The collect waits on the handle's event only,
    not on the later groups' work, which the same stream carries.
    ``max_in_flight`` bounds the handles waiting for the caller, and one
    group more runs ahead: at most ``max_in_flight + 1`` groups are run
    and not yet taken.  An error on the device thread is raised in the
    caller.

    ``chain``: a (classifier, indexer) pair whose heads run in each
    group's program (:func:`marie_tpu_torch.ocr.fused_chain.fused_ocr_chain`);
    their outputs ride on the handle.

    ``mesh``: a local mesh (as :func:`fused_ocr_pages` takes it).  A group
    whose padded size divides by its entry count is split over it; any
    other group runs whole on the processors' device, as the JAX stream
    runs it unsharded (``mesh_used=None``), and adds one to
    :data:`MESH_GROUPS`'s ``"unsharded"``.  Each entry's work runs on the
    entry's kept thread."""
    from marie_tpu_torch.ocr.fused_chain import fused_ocr_chain

    mesh = resolve_mesh(mesh, box_processor.device)
    if upload_format not in UPLOAD_FORMATS:
        raise ValueError(f"upload_format must be one of {UPLOAD_FORMATS}, "
                         f"got {upload_format!r}")
    del rec_slots
    bp, op = box_processor, ocr_processor
    device = bp.device
    preps = [bp.prep_page(im) for im in images]
    groups = _plan_groups(preps, page_batch)

    def run_group(group) -> GroupHandle:
        if device.type == "cuda" and device.index is not None:
            torch.cuda.set_device(device)  # the current device is per thread
        pages, clip, psize, packed = _upload_group(
            preps, group, page_batch, upload_format, device)
        total_slots = psize * compact_slots
        heads = None
        used = mesh if mesh is not None and psize % mesh.size == 0 else None
        if mesh is not None:
            _count_group("sharded" if used is not None else "unsharded")
        if chain is None:
            stats, tokens, conf = fused_ocr_pages(
                bp, op, pages, clip, n_real=len(group),
                total_slots=total_slots, packed=packed, mesh=used)
        else:
            stats, tokens, conf, *heads = fused_ocr_chain(
                bp, op, *chain, pages, clip, n_real=len(group),
                total_slots=total_slots, packed=packed, mesh=used)
            heads = tuple(_to_host(t) for t in heads)
        stats = {k: _to_host(v) for k, v in stats.items()}
        tokens, conf = _to_host(tokens), _to_host(conf)
        ready = None
        if device.type == "cuda":
            ready = torch.cuda.Event(enable_timing=True)
            ready.record()
        metas = [(preps[k][1], preps[k][2]) for k in group]
        return GroupHandle(stats, tokens, conf, pages, packed, metas, total_slots, ready,
                           heads)

    stream = _Stream(groups, run_group, max_in_flight)
    _DEVICE.add(stream)
    try:
        while True:
            kind, val = stream.q.get()
            if kind == "end":
                return
            if kind == "err":
                raise val
            stream.slots.release()
            _DEVICE.wake()
            yield val
    finally:
        stream.closed = True
        _DEVICE.wake()


def fused_dispatch_many(box_processor, ocr_processor, images,
                        rec_slots: int = 256, page_batch: int = 4,
                        compact_slots: int = 192, upload_format: str = "u8",
                        mesh=None, chain=None) -> List[GroupHandle]:
    """List form of :func:`fused_dispatch_stream`: every group's handle,
    dispatched before the first is collected."""
    return list(fused_dispatch_stream(
        box_processor, ocr_processor, images,
        rec_slots=rec_slots, page_batch=page_batch,
        compact_slots=compact_slots, max_in_flight=max(len(images), 1),
        upload_format=upload_format, mesh=mesh, chain=chain,
    ))


def handle_page_count(handle: GroupHandle) -> int:
    """Pages covered by one dispatch handle."""
    return len(handle.metas)


def _handle_pages(bp, tokenizer, handle):
    """The pages of one collected handle, in page order: (stats, texts,
    confidences, row_base, budget, page_fn, scale, (h, w), heads).  Page-
    local decoded row r of a page lives at ``texts[row_base + r]`` and is
    past the budget from row ``budget`` on; ``page_fn()`` gives the page
    as uploaded (unpacked), for the overflow rows."""
    with record_function("marie.collect"):
        stats_host = {k: v.numpy() for k, v in handle.stats.items()}
        tokens = handle.tokens.numpy()
        # every decoded row of the handle in one vectorised pass
        flat_texts = tokenizer.decode_batch(tokens.reshape(-1, tokens.shape[-1]))
        conf_list = np.asarray(handle.conf.numpy(), np.float64).reshape(-1).tolist()
    if isinstance(handle, PageHandle):
        if handle.kind == "s":
            scale, hw = handle.metas[0]
            yield (stats_host, flat_texts, conf_list, 0, handle.rec_slots,
                   lambda: handle.pages, scale, hw, None)
            return
        r = tokens.shape[1]
        for s, (scale, hw) in enumerate(handle.metas):
            yield ({k: v[s] for k, v in stats_host.items()},
                   flat_texts[s * r:(s + 1) * r], conf_list[s * r:(s + 1) * r], 0,
                   handle.rec_slots, lambda s=s: handle.pages[s], scale, hw, None)
        return
    heads = None if handle.heads is None else [t.numpy() for t in handle.heads]
    row_base = 0
    for s, (scale, hw) in enumerate(handle.metas):
        stats_i = {k: v[s] for k, v in stats_host.items()}
        yield (stats_i, flat_texts, conf_list, row_base, handle.total_slots,
               lambda s=s: _unpack_bits(handle.pages[s], handle.packed), scale, hw,
               None if heads is None else [t[s] for t in heads])
        row_base += _kept_count(bp, stats_i)


def fused_collect_many(
    box_processor, ocr_processor, handles, pms_modes
) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray,
                List[Dict[str, Any]], Optional[Dict[str, Any]]]]:
    """Collect dispatched handles on the host: the groups'
    (:class:`GroupHandle`) and the per-page programs' (:class:`PageHandle`,
    ``"s"`` and ``"g"``), in any mix.

    Returns per page: (boxes_int xywh organized, scores, lines,
    line_bboxes, word dicts aligned to the organized boxes, extra).  Kept
    boxes past a handle's row budget are recognised here through
    ``recognize_dispatch`` on the page as uploaded (unpacked on the
    device), with the organized integer boxes, as the JAX engine does.

    With chained heads, each word of a page-local kept row below the
    sequence cap gets ``ner_label_id`` / ``ner_score``, and extra is
    ``{"classification": {"label_id", "score"}}`` from a float32 softmax
    of the page's logits; else extra is None."""
    bp, op = box_processor, ocr_processor
    out = []
    page_i = 0
    for handle in handles:
        if handle.ready is not None:
            handle.ready.synchronize()
        for (stats_i, texts, conf_list, row_base, budget, page_fn, scale, (h, w),
             heads) in _handle_pages(bp, op.tokenizer, handle):
            with record_function("marie.collect"):
                xywh, scores, rows = bp.detect_collect(
                    (None, None, scale, (h, w)), stats=stats_i, return_rows=True)
                boxes_int, scores_o, lines, line_bboxes, order = bp.organize_boxes(
                    xywh, scores, (h, w), pms_modes[page_i], return_order=True)
                words: List[Dict[str, Any]] = []
                overflow: List[int] = []  # organized positions past the budget
                rows_j = (row_base + np.asarray(rows)[np.asarray(order)]).tolist()
                for j, row in enumerate(rows_j):
                    if row < budget:
                        words.append({"text": texts[row], "confidence": conf_list[row]})
                    else:
                        words.append({"text": "", "confidence": 0.0})
                        overflow.append(j)
            if overflow:
                with record_function("marie.overflow"), launch_path("overflow"):
                    tail = np.asarray([boxes_int[j] for j in overflow], np.float32)
                    fut = op.recognize_dispatch(page_fn(), tail, scale)
                    for j, wd in zip(overflow, op.recognize_collect(fut)):
                        words[j] = wd
            extra = None if heads is None else _attach_heads(words, rows, order, *heads)
            out.append((boxes_int, scores_o, lines, line_bboxes, words, extra))
            page_i += 1
    return out


def _attach_heads(words, rows, order, cls_logits, ner_labels, ner_scores) -> Dict[str, Any]:
    """Per-word NER labels by page-local kept row (rows past the sequence
    cap get none) and the page's classification."""
    for j in range(len(words)):
        r = int(rows[order[j]])
        if r < len(ner_labels):
            words[j]["ner_label_id"] = int(ner_labels[r])
            words[j]["ner_score"] = float(ner_scores[r])
    logits = np.asarray(cls_logits, np.float32)
    probs = np.exp(logits - logits.max())
    probs /= probs.sum()
    return {"classification": {"label_id": int(logits.argmax()), "score": float(probs.max())}}


def _kept_count(bp, stats) -> int:
    """Device keep-predicate replica (see :func:`keep_predicate`): how
    many component slots of one page's stats survive on the device and
    so occupy compacted recognition rows."""
    stride = float(np.asarray(stats.get("stride", 2)))
    # compare in float32 on the fetched arrays, as the device does; a
    # python float would promote to float64 and disagree for scores equal
    # to float32(threshold), shifting every later row
    floor = np.float32(0.0 if bp.box_source == "ink" else bp.text_threshold)
    min_area = np.float32(bp.min_area) / np.float32(stride / 2.0) ** 2
    keep = (
        np.asarray(stats["valid"])
        & (np.asarray(stats["scores"], dtype=np.float32) >= floor)
        & (np.asarray(stats["areas"], dtype=np.float32) >= min_area)
    )
    return int(keep.sum())
