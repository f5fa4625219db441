"""Connected components and component box stats (port of
``marie_tpu/ops/connected_components.py``).

Five stats functions fill the same fixed-size slots from a mask: a
component is named by the min linear index of its pixels, the K smallest
names fill the K slots in ascending order (components past K are dropped,
by name), and each slot gets its box (xyxy, pixel cells), area, max score
and a valid flag.

* :func:`component_boxes_runs_cc` (the path's default, ``runs_cc``) takes
  the mask itself: labels and stats in the run domain, so the pixel label
  grid is never built.  Each row's masked pixels compact to at most
  ``max_runs_per_row`` runs (runs past the budget are dropped, exactly as
  in the JAX version), runs in adjacent rows connect under
  8-connectivity when their intervals overlap after a one-pixel dilation,
  and label propagation with pointer jumping runs over the [H, R] run
  table.
* :func:`component_boxes` (``sort``), :func:`component_boxes_reduce`
  (``reduce``), :func:`component_boxes_reduce2` (``reduce2``) and
  :func:`component_boxes_runs` (``runs``) take the pixel label map of
  :func:`connected_components`.

The JAX versions differ in how they reduce (a full-pixel sort with
segmented scans, masked broadcasts over [N, K], row and column
projections, per-row runs), a choice of TPU cost.  Here every variant
scatters (``scatter_reduce`` amin/amax/sum over exact integer and max
values) into the slots of its K names, which gives the JAX numbers
without the [N, K] intermediates; the variants differ where their JAX
outputs differ:

* the score of ``reduce`` and ``reduce2`` is floored at 0 unless the
  component covers every pixel (their reductions start from 0), that of
  ``sort`` is the plain max;
* ``runs`` and ``runs_cc`` floor each run's score at 0 unless it spans
  the row, and the slot's at 0 unless every run slot matched, and drop
  the runs past ``max_runs_per_row`` (``runs`` keeps the slot of a
  component whose runs were all dropped: box ``[H*W, y0, 0, 0]``,
  area 0).

The K smallest names are taken by value (a sort of the name table), so
the order among equal values, which ``lax.top_k`` fixes and
``torch.topk`` does not, plays no part.  The batch dimension is written
out: masks and label maps are [B, H, W] (or one [H, W]).
"""

from typing import Dict, Optional

import torch
import torch.nn.functional as F

Stats = Dict[str, torch.Tensor]


def _scatter(init: torch.Tensor, index: torch.Tensor, src: torch.Tensor,
             reduce: str) -> torch.Tensor:
    return init.scatter_reduce(0, index, src, reduce=reduce, include_self=True)


def _batched(fn):
    """Let a stats function of [B, H, W] inputs take one [H, W] page."""
    def wrapper(x, scores=None, *args, **kwargs):
        if x.ndim == 2:
            out = fn(x[None], None if scores is None else scores[None], *args, **kwargs)
            return {key: v[0] for key, v in out.items()}
        return fn(x, scores, *args, **kwargs)

    wrapper.__name__, wrapper.__doc__ = fn.__name__, fn.__doc__
    return wrapper


def _smallest(names: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """[B, E] names (``n``: none) -> the K smallest per row, ascending,
    padded with ``n``."""
    reps = torch.sort(names, dim=1).values[:, :k].contiguous()
    if reps.shape[1] < k:
        reps = F.pad(reps, (0, k - reps.shape[1]), value=n)
    return reps


def _pixel_reps(labels: torch.Tensor, k: int) -> torch.Tensor:
    """The K smallest component names of [B, H, W] labels: pixels whose
    label is their own linear index."""
    b, h, w = labels.shape
    n = h * w
    flat = labels.reshape(b, n)
    lin = torch.arange(n, dtype=flat.dtype, device=flat.device)
    return _smallest(torch.where((flat == lin) & (flat >= 0), lin, n), k, n)


def _row_runs(mask: torch.Tensor, r: int):
    """Row compaction: each row's first ``r`` runs of masked pixels.
    Returns (member [B, H, W] bool: a pixel of a kept run, slot [M] int64:
    the flat run slot ``(b * H + y) * r + run`` of each member, x0, x1
    [B, H, r] float32 (``H*W`` and -1 where empty), count [B, H, r] int32)."""
    dev = mask.device
    b, h, w = mask.shape
    n, hr = h * w, h * r
    left = torch.cat([torch.zeros_like(mask[:, :, :1]), mask[:, :, :-1]], dim=2)
    run_of_pixel = torch.cumsum((mask & ~left).to(torch.int32), dim=2,
                                dtype=torch.int32) - 1
    member = mask & (run_of_pixel < r)
    row = torch.arange(h, device=dev)
    slot = ((torch.arange(b, device=dev)[:, None, None] * h + row[None, :, None]) * r
            + run_of_pixel.to(torch.int64))[member]
    xs = torch.arange(w, device=dev, dtype=torch.float32).expand(b, h, w)[member]
    x0 = _scatter(torch.full((b * hr,), float(n), device=dev), slot, xs, "amin")
    x1 = _scatter(torch.full((b * hr,), -1.0, device=dev), slot, xs, "amax")
    cnt = torch.zeros(b * hr, dtype=torch.int32, device=dev).index_add_(
        0, slot, torch.ones_like(slot, dtype=torch.int32))
    return member, slot, x0.view(b, h, r), x1.view(b, h, r), cnt.view(b, h, r)


def _run_scores(scores: torch.Tensor, member, slot, count, w: int) -> torch.Tensor:
    """Each run's max score, floored at 0 unless the run spans the row
    (the JAX reduction's ``where(member, score, 0)``): [B, H*r]."""
    b, h, r = count.shape
    sc = scores.to(torch.float32)[member]
    scr = _scatter(torch.full((b * h * r,), float("-inf"), device=sc.device), slot,
                   sc, "amax").view(b, h, r)
    return torch.where(count < w, torch.clamp(scr, min=0.0), scr).reshape(b, h * r)


def _slot_stats(reps: torch.Tensor, names: torch.Tensor, n: int, w: int,
                x0: torch.Tensor, x1: torch.Tensor, y: torch.Tensor,
                count: torch.Tensor, score: Optional[torch.Tensor],
                floor_below: Optional[int]) -> Stats:
    """Per-slot stats from elements (pixels or runs) named ``names``
    [B, E]: box from the min of ``x0`` and the max of ``x1`` and ``y``
    (y0 is the name's row: names are min linear indices), area the sum of
    ``count``, score the max of ``score``, floored at 0 while fewer than
    ``floor_below`` elements matched (None: no floor).  Elements named
    outside the slots (``n``, -1, or a dropped component) count nowhere."""
    dev = reps.device
    b, k = reps.shape
    pos = torch.searchsorted(reps, names).clamp(max=k - 1)
    hit = (reps.gather(1, pos) == names) & (names >= 0) & (names < n)
    idx = (torch.arange(b, device=dev)[:, None] * k + pos)[hit]
    sx0 = _scatter(torch.full((b * k,), float(n), device=dev), idx, x0[hit], "amin")
    sx1 = _scatter(torch.full((b * k,), -1.0, device=dev), idx, x1[hit], "amax")
    sy1 = _scatter(torch.full((b * k,), -1.0, device=dev), idx, y[hit], "amax")
    areas = torch.zeros(b * k, dtype=torch.int32, device=dev).index_add_(0, idx, count[hit])
    sx0, sx1, sy1, areas = (t.view(b, k) for t in (sx0, sx1, sy1, areas))
    y0 = torch.div(reps, w, rounding_mode="floor").to(torch.float32)
    valid = reps < n
    boxes = torch.stack([sx0, y0, sx1 + 1.0, sy1 + 1.0], dim=-1)
    boxes = torch.where(valid[..., None], boxes, 0.0)
    if score is not None:
        smax = _scatter(torch.full((b * k,), float("-inf"), device=dev), idx,
                        score[hit], "amax").view(b, k)
        if floor_below is not None:
            nmatch = torch.zeros(b * k, dtype=torch.int32, device=dev).index_add_(
                0, idx, torch.ones_like(idx, dtype=torch.int32)).view(b, k)
            smax = torch.where(nmatch < floor_below, torch.clamp(smax, min=0.0), smax)
        smax = torch.where(valid, smax, 0.0)
    else:
        smax = valid.to(torch.float32)
    return {
        "boxes": boxes.to(torch.float32),
        "areas": torch.where(valid, areas, 0).to(torch.int32),
        "scores": smax.to(torch.float32),
        "valid": valid,
    }


@_batched
def component_boxes_runs_cc(
    mask: torch.Tensor,  # [B, H, W] or [H, W] bool
    scores: Optional[torch.Tensor] = None,  # same shape, float
    max_components: int = 256,
    max_runs_per_row: int = 48,
    num_iters: int = 32,
) -> Stats:
    """Mask -> fixed-size component stats, per page:
    boxes [K, 4] float32 xyxy (zeros in empty slots), areas [K] int32,
    scores [K] float32 (per-component max; 0 where empty), valid [K] bool."""
    dev = mask.device
    b, h, w = mask.shape
    n = h * w
    r = max_runs_per_row
    hr = h * r
    big = hr  # invalid RUN id sentinel
    i32 = torch.int32

    member, slot, x0r, x1r, cntr = _row_runs(mask, r)
    valid_run = cntr > 0
    ys = torch.arange(h, device=dev)[:, None].expand(h, r).to(i32)
    pix_of_run = torch.where(valid_run, ys * w + x0r.to(i32), n).reshape(b, hr)

    # --- label propagation over the run graph ---
    run_ids = torch.arange(hr, device=dev, dtype=i32).view(h, r)
    lbl = torch.where(valid_run, run_ids, big)
    ov = (
        (x0r[:, :-1, :, None] <= x1r[:, 1:, None, :] + 1.0)
        & (x1r[:, :-1, :, None] >= x0r[:, 1:, None, :] - 1.0)
        & valid_run[:, :-1, :, None]
        & valid_run[:, 1:, None, :]
    )  # [B, H-1, R, R]: run i of row y vs run j of row y+1
    big_row = torch.full((b, 1, r), big, dtype=i32, device=dev)
    big_col = torch.full((b, 1), big, dtype=i32, device=dev)

    def sweep(cur):
        up, dn = cur[:, :-1], cur[:, 1:]
        dn_new = torch.where(ov, up[:, :, :, None], big).amin(dim=2)
        up_new = torch.where(ov, dn[:, :, None, :], big).amin(dim=3)
        out = torch.minimum(cur, torch.cat([up_new, big_row], dim=1))
        out = torch.minimum(out, torch.cat([big_row, dn_new], dim=1))
        # pointer jumping: label <- label of the run my label names (x2)
        flat = out.reshape(b, hr)
        for _ in range(2):
            padded = torch.cat([flat, big_col], dim=1)
            flat = torch.minimum(flat, padded.gather(1, flat.clamp(max=hr).long()))
        return torch.where(valid_run, flat.view(b, h, r), big)

    # a converged page is a fixed point of sweep, so sweeping the batch
    # until no page changes (or num_iters) equals the per-page loop
    for _ in range(num_iters):
        new = sweep(lbl)
        changed = bool((new != lbl).any())
        lbl = new
        if not changed:
            break

    # --- reps: the K smallest component names, ascending ---
    flat_lbl = lbl.reshape(b, hr)
    is_root = valid_run.reshape(b, hr) & (flat_lbl == run_ids.reshape(1, hr))
    reps = _smallest(torch.where(is_root, pix_of_run, n), max_components, n)
    # component name of every run (empty runs: n)
    padded_pix = torch.cat([pix_of_run, torch.full((b, 1), n, dtype=i32, device=dev)], 1)
    names = padded_pix.gather(1, flat_lbl.clamp(max=hr).long())
    score = (None if scores is None
             else _run_scores(scores, member, slot, cntr, w))
    return _slot_stats(reps, names, n, w, x0r.reshape(b, hr), x1r.reshape(b, hr),
                       ys.to(torch.float32).reshape(1, hr).expand(b, hr),
                       cntr.reshape(b, hr), score, hr)


@_batched
def component_boxes_runs(
    labels: torch.Tensor,  # [B, H, W] or [H, W] int32, -1 background
    scores: Optional[torch.Tensor] = None,
    max_components: int = 256,
    max_runs_per_row: int = 48,
) -> Stats:
    """``runs``: stats of a label map through per-row runs; equal to the
    other variants while every row holds at most ``max_runs_per_row``
    runs (past that a row's rightmost runs are dropped, shrinking the
    affected boxes)."""
    dev = labels.device
    b, h, w = labels.shape
    n, r = h * w, max_runs_per_row
    hr = h * r
    member, slot, x0r, x1r, cntr = _row_runs(labels >= 0, r)
    # a run is one component: the min of its labels is its name
    names = _scatter(torch.full((b * hr,), n, dtype=labels.dtype, device=dev), slot,
                     labels[member], "amin").view(b, hr)
    ys = torch.arange(h, device=dev, dtype=torch.float32)[:, None].expand(h, r)
    score = (None if scores is None
             else _run_scores(scores, member, slot, cntr, w))
    return _slot_stats(_pixel_reps(labels, max_components), names, n, w,
                       x0r.reshape(b, hr), x1r.reshape(b, hr),
                       ys.reshape(1, hr).expand(b, hr), cntr.reshape(b, hr), score, hr)


def _pixel_stats(labels: torch.Tensor, scores: Optional[torch.Tensor],
                 max_components: int, floor: bool) -> Stats:
    b, h, w = labels.shape
    n = h * w
    lin = torch.arange(n, device=labels.device)
    xs = (lin % w).to(torch.float32).expand(b, n)
    ys = torch.div(lin, w, rounding_mode="floor").to(torch.float32).expand(b, n)
    score = None if scores is None else scores.reshape(b, n).to(torch.float32)
    return _slot_stats(_pixel_reps(labels, max_components), labels.reshape(b, n), n, w,
                       xs, xs, ys, torch.ones((b, n), dtype=torch.int32,
                                              device=labels.device),
                       score, n if floor else None)


@_batched
def component_boxes(labels: torch.Tensor, scores: Optional[torch.Tensor] = None,
                    max_components: int = 256) -> Stats:
    """``sort``: stats of a [B, H, W] (or [H, W]) label map
    (:func:`connected_components`; -1 background).  ``scores`` is an
    optional float map whose per-component max each slot reports (its
    plain max; without one, ``valid`` as float)."""
    return _pixel_stats(labels, scores, max_components, floor=False)


@_batched
def component_boxes_reduce(labels: torch.Tensor, scores: Optional[torch.Tensor] = None,
                           max_components: int = 256) -> Stats:
    """``reduce``: :func:`component_boxes` with the score floored at 0
    unless the component covers every pixel."""
    return _pixel_stats(labels, scores, max_components, floor=True)


#: ``reduce2``: the same outputs as :func:`component_boxes_reduce`
component_boxes_reduce2 = component_boxes_reduce


def _run_min(lbl: torch.Tensor, mask: torch.Tensor, big: int) -> torch.Tensor:
    """Every masked pixel gets the min label of its contiguous run along
    the last axis of [rows, W]; unmasked pixels get ``big``."""
    h, w = lbl.shape
    left = torch.cat([torch.zeros_like(mask[:, :1]), mask[:, :-1]], dim=1)
    rid = torch.cumsum((mask & ~left).to(torch.int64), dim=1) - 1
    rid = rid + torch.arange(h, device=lbl.device)[:, None] * w
    sel = mask.reshape(-1)
    ids = rid.reshape(-1)[sel]
    mins = torch.full((h * w,), big, dtype=lbl.dtype, device=lbl.device)
    mins = mins.scatter_reduce(0, ids, lbl.reshape(-1)[sel], "amin")
    out = torch.full_like(lbl, big).reshape(-1)
    out[sel] = mins[ids]
    return out.view(h, w)


def connected_components(mask: torch.Tensor, num_iters: int = 64) -> torch.Tensor:
    """8-connected labels of a bool mask [H, W] (or a batch [B, H, W]):
    background -1, each component labelled by the min linear index of
    its pixels in its page.  Sweeps (neighbour min, then the min of each
    row run and each column run) until no page changes, at most
    ``num_iters`` times."""
    if mask.ndim == 2:
        return connected_components(mask[None], num_iters)[0]
    b, h, w = mask.shape
    big = h * w
    lin = torch.arange(h * w, dtype=torch.int32, device=mask.device).view(h, w)
    labels = torch.where(mask, lin, big)
    mask_t = mask.transpose(1, 2).reshape(b * w, h)

    def neighbor_min(lbl):
        p = F.pad(lbl, (1, 1, 1, 1), value=big)
        m = lbl
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy or dx:
                    m = torch.minimum(m, p[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w])
        return torch.where(mask, m, big)

    for _ in range(num_iters):
        new = neighbor_min(labels)
        new = _run_min(new.reshape(b * h, w), mask.reshape(b * h, w), big).view(b, h, w)
        new = _run_min(new.transpose(1, 2).reshape(b * w, h), mask_t, big)
        new = torch.where(mask, new.view(b, w, h).transpose(1, 2), big)
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            break
    return torch.where(mask, labels, -1)
