"""Connected components and component box stats (port of
``marie_tpu/ops/connected_components.py``).

:func:`component_boxes_runs_cc` is the path's variant: labels and stats in
the run domain, so the pixel label grid is never built.  Each row's
masked pixels compact to at most ``max_runs_per_row`` runs (runs past the
budget are dropped, exactly as in the JAX version), runs in adjacent rows
connect under 8-connectivity when their intervals overlap after a
one-pixel dilation, and label propagation with pointer jumping runs over
the [H, R] run table.  A component is named by the min linear index of its
pixels, the K smallest names fill the K slots in ascending order, and each
slot gets box, area and max score.

Where the JAX version reduces over masked broadcasts, this one scatters
(``scatter_reduce`` amin/amax/sum over exact integer and max values), which
gives the same numbers without the [H*R, K] intermediate.  The batch
dimension is written out: masks are [B, H, W] (or one [H, W]).

:func:`connected_components` (pixel-domain labels) is kept as a second
oracle for the tests.
"""

from typing import Dict, Optional

import torch
import torch.nn.functional as F


def _scatter(init: torch.Tensor, index: torch.Tensor, src: torch.Tensor,
             reduce: str) -> torch.Tensor:
    return init.scatter_reduce(0, index, src, reduce=reduce, include_self=True)


def component_boxes_runs_cc(
    mask: torch.Tensor,  # [B, H, W] or [H, W] bool
    scores: Optional[torch.Tensor] = None,  # same shape, float
    max_components: int = 256,
    max_runs_per_row: int = 48,
    num_iters: int = 32,
) -> Dict[str, torch.Tensor]:
    """Mask -> fixed-size component stats, per page:
    boxes [K, 4] float32 xyxy (zeros in empty slots), areas [K] int32,
    scores [K] float32 (per-component max; 0 where empty), valid [K] bool."""
    single = mask.ndim == 2
    if single:
        mask = mask[None]
        scores = None if scores is None else scores[None]
    dev = mask.device
    b, h, w = mask.shape
    n = h * w
    r = max_runs_per_row
    k = max_components
    hr = h * r
    big = hr  # invalid RUN id sentinel
    i32, f32 = torch.int32, torch.float32

    # --- row compaction: run slot of each masked pixel ---
    left = torch.cat([torch.zeros_like(mask[:, :, :1]), mask[:, :, :-1]], dim=2)
    run_of_pixel = torch.cumsum((mask & ~left).to(i32), dim=2, dtype=i32) - 1
    member = mask & (run_of_pixel < r)
    row = torch.arange(h, device=dev)
    slot = ((torch.arange(b, device=dev)[:, None, None] * h + row[None, :, None]) * r
            + run_of_pixel.to(torch.int64))[member]
    xs = torch.arange(w, device=dev, dtype=f32).expand(b, h, w)[member]
    x0r = _scatter(torch.full((b * hr,), float(n), device=dev), slot, xs, "amin")
    x1r = _scatter(torch.full((b * hr,), -1.0, device=dev), slot, xs, "amax")
    cntr = torch.zeros(b * hr, dtype=i32, device=dev).index_add_(
        0, slot, torch.ones_like(slot, dtype=i32))
    x0r, x1r, cntr = (t.view(b, h, r) for t in (x0r, x1r, cntr))
    valid_run = cntr > 0
    ys = row[:, None].expand(h, r).to(i32)
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
    root_pix = torch.where(is_root, pix_of_run, n)
    rep_sorted = torch.sort(root_pix, dim=1, stable=True).values[:, :k].contiguous()
    if rep_sorted.shape[1] < k:
        rep_sorted = F.pad(rep_sorted, (0, k - rep_sorted.shape[1]), value=n)
    valid = rep_sorted < n

    # component name of every run; runs of components outside the K slots
    # (and empty runs, named n) contribute to no slot
    padded_pix = torch.cat([pix_of_run, torch.full((b, 1), n, dtype=i32, device=dev)], 1)
    labr = padded_pix.gather(1, flat_lbl.clamp(max=hr).long())
    pos = torch.searchsorted(rep_sorted, labr).clamp(max=k - 1)
    hit = (rep_sorted.gather(1, pos) == labr) & (labr < n)
    idx = (torch.arange(b, device=dev)[:, None] * k + pos)[hit]
    x0 = _scatter(torch.full((b * k,), float(n), device=dev), idx,
                  x0r.reshape(b, hr)[hit], "amin")
    x1 = _scatter(torch.full((b * k,), -1.0, device=dev), idx,
                  x1r.reshape(b, hr)[hit], "amax")
    ysf = ys.to(f32).reshape(1, hr).expand(b, hr)[hit]
    y1 = _scatter(torch.full((b * k,), -1.0, device=dev), idx, ysf, "amax")
    areas = torch.zeros(b * k, dtype=i32, device=dev).index_add_(
        0, idx, cntr.reshape(b, hr)[hit])
    x0, x1, y1, areas = (t.view(b, k) for t in (x0, x1, y1, areas))
    y0 = torch.div(rep_sorted, w, rounding_mode="floor").to(f32)

    boxes = torch.stack([x0, y0, x1 + 1.0, y1 + 1.0], dim=-1)
    boxes = torch.where(valid[..., None], boxes, 0.0)

    if scores is not None:
        # per run: max score over its pixels, floored at 0 unless the run
        # spans the whole row (the JAX reduction's where(.., 0.0) floor)
        sc = scores.to(f32)[member]
        scr = _scatter(torch.full((b * hr,), float("-inf"), device=dev), slot,
                       sc, "amax").view(b, h, r)
        scr = torch.where(cntr < w, torch.clamp(scr, min=0.0), scr).reshape(b, hr)
        smax = _scatter(torch.full((b * k,), float("-inf"), device=dev), idx,
                        scr[hit], "amax").view(b, k)
        nmatch = torch.zeros(b * k, dtype=i32, device=dev).index_add_(
            0, idx, torch.ones_like(idx, dtype=i32)).view(b, k)
        smax = torch.where(nmatch < hr, torch.clamp(smax, min=0.0), smax)
        smax = torch.where(valid, smax, 0.0)
    else:
        smax = valid.to(f32)

    out = {
        "boxes": boxes.to(f32),
        "areas": torch.where(valid, areas, 0).to(i32),
        "scores": smax.to(f32),
        "valid": valid,
    }
    if single:
        out = {key: v[0] for key, v in out.items()}
    return out


def _run_min(lbl: torch.Tensor, mask: torch.Tensor, big: int) -> torch.Tensor:
    """Every masked pixel gets the min label of its contiguous run along
    the last axis; unmasked pixels get ``big``."""
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
    """8-connected labels of a bool mask [H, W]: background -1, each
    component labelled by the min linear index of its pixels."""
    h, w = mask.shape
    big = h * w
    lin = torch.arange(h * w, dtype=torch.int32, device=mask.device).view(h, w)
    labels = torch.where(mask, lin, big)

    def neighbor_min(lbl):
        p = F.pad(lbl, (1, 1, 1, 1), value=big)
        m = lbl
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy or dx:
                    m = torch.minimum(m, p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w])
        return torch.where(mask, m, big)

    for _ in range(num_iters):
        new = neighbor_min(labels)
        new = _run_min(new, mask, big)
        new = _run_min(new.t().contiguous(), mask.t().contiguous(), big).t()
        new = torch.where(mask, new, big)
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            break
    return torch.where(mask, labels, -1)
