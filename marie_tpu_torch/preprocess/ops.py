"""Page and crop preprocessing (port of ``marie_tpu/preprocess/ops.py``).

:func:`crop_resize_pages` is the plain PyTorch version of the word-crop
kernel (``ops/kernels/crop_resize.py``) on grayscale stacks: the CPU path,
and the reference the CUDA kernel is held against on the card.  On RGB
stacks it is the crop itself on every device, as in the JAX package.
"""

from typing import Tuple

import torch


def normalize_page(img: torch.Tensor) -> torch.Tensor:
    """uint8 [..., H, W, C] -> float32 in [0, 1].  Multiplies by the
    float32 reciprocal of 255, which is what XLA compiles the JAX
    version's ``/ 255.0`` to, so both give the same bits."""
    return img.to(torch.float32) * (1.0 / 255.0)


def to_grayscale(img: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 3] float32 -> [..., H, W] luma 0.299 R + 0.587 G +
    0.114 B, rounded as XLA's CPU dot rounds it (a chain of fused
    multiply-adds, emulated exactly in float64): Otsu compares these
    values against a threshold, so the last bit decides ink pixels."""
    w = (0.299, 0.587, 0.114)
    f32 = torch.tensor(w, dtype=torch.float32).double().tolist()
    x = img.to(torch.float64)
    acc = (x[..., 0] * f32[0]).to(torch.float32)
    acc = (x[..., 1] * f32[1] + acc.double()).to(torch.float32)
    acc = (x[..., 2] * f32[2] + acc.double()).to(torch.float32)
    return acc


def otsu_binarize(gray: torch.Tensor) -> torch.Tensor:
    """Otsu thresholding. gray float [..., H, W] in [0, 1] -> bool mask of
    INK pixels (True = dark), one threshold per leading index.

    The histogram and its prefix sums are exact integers; the class means
    and the between-class variance are float32 as in the JAX version,
    whose float32 prefix sums are exact while they stay below 2**24
    (pages up to ~65K pixels) and may round differently above that."""
    nbins = 256
    lead = gray.shape[:-2]
    g = gray.reshape(-1, gray.shape[-2] * gray.shape[-1])
    b = g.shape[0]
    flat = torch.clamp((g * (nbins - 1)).to(torch.int32), 0, nbins - 1)
    offs = torch.arange(b, device=g.device, dtype=torch.int64)[:, None] * nbins
    hist = torch.bincount(
        (flat.to(torch.int64) + offs).reshape(-1), minlength=b * nbins
    ).reshape(b, nbins)
    bins = torch.arange(nbins, dtype=torch.int64, device=g.device)
    # class counts and moments as exact integer prefix sums, rounded to
    # float32 once (the same on every device and in every summation order)
    w0 = torch.cumsum(hist, dim=1).to(torch.float32)
    w1 = hist.sum(dim=1, keepdim=True).to(torch.float32) - w0
    sum0_i = torch.cumsum(hist * bins, dim=1)
    sum_all = sum0_i[:, -1:].to(torch.float32)
    sum0 = sum0_i.to(torch.float32)
    mu0 = sum0 / torch.clamp(w0, min=1.0)
    mu1 = (sum_all - sum0) / torch.clamp(w1, min=1.0)
    between = w0 * w1 * (mu0 - mu1) ** 2
    # XLA folds the JAX version's / 255 into a reciprocal multiply
    t = torch.argmax(between, dim=1).to(torch.float32) * (1.0 / (nbins - 1))
    return (g <= t[:, None]).reshape(*lead, *gray.shape[-2:])


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c with one rounding (the product is exact in
    float64), as XLA's CPU backend contracts the JAX code's multiply-adds."""
    return (a.to(torch.float64) * b.to(torch.float64) + c.to(torch.float64)).to(torch.float32)


def crop_resize_pages(
    pages: torch.Tensor,  # [P, H, W] or [P, H, W, C] uint8
    page_idx: torch.Tensor,  # [N] int32 — which page each box crops from
    boxes: torch.Tensor,  # [N, 4] xyxy float32 (page coords)
    out_h: int,
    out_w: int,
    channel_mean: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cut N boxes out of a page stack, resize each to (out_h, out_w):
    aspect-preserving separable bilinear, the x step widened to
    ``max(bh/out_h, bw/out_w)`` so wide words squeeze instead of losing
    their tail, white (1.0) past each crop's effective width
    ``eff_w = min(round(bw * out_h / bh), out_w)``.

    Returns (crops [N, out_h, out_w] for a [P, H, W] stack, [N, out_h,
    out_w, C] for [P, H, W, C], float32 in [0, 1], eff_w [N] int32).  The
    uint8 pixels turn float after the gather, as in the JAX version.
    With ``channel_mean`` the crops are [N, out_h, out_w]: the mean of the
    three channels of a [P, H, W, 3] stack, or of a [P, H, W] stack
    expanded to three equal channels, as the JAX CRNN processor takes
    it, rounded as XLA fuses the crop's scale into that mean: ``((v0 *
    s) fma v1 * s) fma v2 * s``, times float32(1/3), with ``v`` a
    channel's unscaled crop and ``s`` float32(1/255).

    Every rounding is the one XLA's CPU backend gives the JAX version, so
    the two agree bit for bit: a divide by a constant is a multiply by its
    float32 reciprocal, ``a * b + c`` is one fused multiply-add (:func:`fma`),
    and ``out_h / bh`` is a true divide.  The CUDA kernel does the same
    operations in the same order on grayscale stacks."""
    if pages.ndim not in (3, 4):
        raise ValueError(f"pages must be [P, H, W] or [P, H, W, C], got {tuple(pages.shape)}")
    dev = pages.device
    p, h, w = pages.shape[:3]
    chans = pages.shape[3:]  # () or (C,)
    boxes = boxes.to(torch.float32)
    x0, y0, x1, y1 = boxes.unbind(1)
    bh = torch.clamp(y1 - y0, min=1.0)
    bw = torch.clamp(x1 - x0, min=1.0)
    scale = torch.div(torch.full_like(bh, float(out_h)), bh)
    eff_w = torch.clamp(torch.round(bw * scale), max=float(out_w))

    ys_frac = (torch.arange(out_h, dtype=torch.float32, device=dev) + 0.5) * (1.0 / out_h)
    xs_idx = torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5
    sy = torch.clamp(fma(ys_frac[None, :], bh[:, None], y0[:, None]) - 0.5, 0.0, h - 1.0)
    step = torch.maximum(bh * (1.0 / out_h), bw * (1.0 / out_w))
    sx = torch.clamp(fma(xs_idx[None, :], step[:, None], x0[:, None]) - 0.5, 0.0, w - 1.0)

    # the two source rows and columns of every output pixel
    y0i = torch.floor(sy).to(torch.int64)[:, :, None]  # [N, out_h, 1]
    y1i = torch.clamp(y0i + 1, max=h - 1)
    x0i = torch.floor(sx).to(torch.int64)[:, None, :]  # [N, 1, out_w]
    x1i = torch.clamp(x0i + 1, max=w - 1)
    tail = (None,) * len(chans)  # weights broadcast over the channels
    ly = (sy[:, :, None] - y0i)[(...,) + tail]
    lx = (sx[:, None, :] - x0i)[(...,) + tail]
    flat = pages.reshape(p, h * w, *chans)
    pidx = torch.clamp(page_idx.to(torch.int64), 0, p - 1)
    n = len(pidx)

    def px(yi, xi):
        return flat[pidx[:, None], (yi * w + xi).reshape(n, -1)].reshape(
            n, out_h, out_w, *chans).to(torch.float32)

    c0 = fma(px(y0i, x0i), 1.0 - ly, px(y1i, x0i) * ly)  # rows at column x0
    c1 = fma(px(y0i, x1i), 1.0 - ly, px(y1i, x1i) * ly)  # rows at column x1
    vals = fma(c0, 1.0 - lx, c1 * lx)
    pad = torch.arange(out_w, device=dev)[None, None, :] >= eff_w[:, None, None]
    crops = torch.where(pad[(...,) + tail], 255.0, vals)
    if not channel_mean:
        return crops * (1.0 / 255.0), eff_w.to(torch.int32)
    if chans not in ((), (3,)):
        raise ValueError(f"a channel mean takes 1 or 3 channels, got {chans}")
    v = crops.unbind(-1) if chans else (crops,) * 3
    s = torch.tensor(1.0 / 255.0, dtype=torch.float32, device=dev)
    total = fma(v[2], s, fma(v[1], s, v[0] * s))
    return total * (1.0 / 3.0), eff_w.to(torch.int32)
