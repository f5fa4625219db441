"""Page and crop preprocessing (port of ``marie_tpu/preprocess/ops.py``).

:func:`crop_resize_pages` is the plain PyTorch version of the word-crop
kernel (``ops/kernels/crop_resize.py``) on grayscale stacks: the CPU path,
and the reference the CUDA kernel is held against on the card.  On RGB
stacks it is the crop itself on every device, as in the JAX package.
:func:`crop_resize` is the one-page crop of float pages, :func:`resize_page`
``jax.image.resize``'s bilinear resize and :func:`prepare_page` the page
graph (normalise, luma, Otsu); each takes the device it runs on.
"""

from typing import Dict, Tuple

import numpy as np
import torch

from marie_tpu_torch.utils.device import resolve_device


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


def _bilinear_hwc(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of ``img`` [H, W, C] float32 at float coordinates
    ``ys``, ``xs`` (any equal shape S) -> [*S, C], or of a stack [B, H, W,
    C] at [B, ...] coordinates, each page sampled at its own; coordinates
    clamp to the border.  The JAX version's four-term sum, rounded as
    XLA's CPU backend contracts it (three fused multiply-adds, :func:`fma`),
    so that the two agree to the bit on equal coordinates."""
    if img.ndim == 3:
        return _bilinear_hwc(img[None], ys[None], xs[None])[0]
    b, h, w = img.shape[:3]
    ys = torch.clamp(ys, 0.0, h - 1.0)
    xs = torch.clamp(xs, 0.0, w - 1.0)
    y0 = torch.floor(ys).to(torch.int64)
    x0 = torch.floor(xs).to(torch.int64)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    ly = (ys - y0)[..., None]
    lx = (xs - x0)[..., None]
    flat = img.reshape(b, h * w, img.shape[3])
    pages = torch.arange(b, device=img.device).view(b, *([1] * (ys.ndim - 1)))

    def px(yi, xi):
        return flat[pages, yi * w + xi]

    a, c = 1 - ly, 1 - lx
    # v00 a c + v01 a lx + v10 ly c + v11 ly lx
    acc = fma(px(y0, x0) * a, c, px(y0, x1) * a * lx)
    acc = fma(px(y1, x0) * ly, c, acc)
    return fma(px(y1, x1) * ly, lx, acc)


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c with one rounding (the product is exact in
    float64), as XLA's CPU backend contracts the JAX code's multiply-adds;
    a float64 operand makes it a float64 multiply-add."""
    out = torch.promote_types(torch.promote_types(a.dtype, b.dtype), c.dtype)
    out = torch.promote_types(out, torch.float32)
    return (a.to(torch.float64) * b.to(torch.float64) + c.to(torch.float64)).to(out)


def _crop_sample(pages: torch.Tensor, page_idx: torch.Tensor, boxes: torch.Tensor, out_h: int,
                 out_w: int, white: float, preserve_aspect: bool = True):
    """The crop shared by :func:`crop_resize_pages` and :func:`crop_resize`:
    (crops [N, out_h, out_w(, C)] float32 in the pages' scale, ``white``
    past each crop's effective width, eff_w [N] float32)."""
    dev = pages.device
    p, h, w = pages.shape[:3]
    chans = pages.shape[3:]  # () or (C,)
    boxes = boxes.to(torch.float32)
    x0, y0, x1, y1 = boxes.unbind(1)
    bh = torch.clamp(y1 - y0, min=1.0)
    bw = torch.clamp(x1 - x0, min=1.0)
    if preserve_aspect:
        scale = torch.div(torch.full_like(bh, float(out_h)), bh)
        eff_w = torch.clamp(torch.round(bw * scale), max=float(out_w))
    else:
        eff_w = torch.full_like(bw, float(out_w))

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
    return torch.where(pad[(...,) + tail], white, vals), eff_w


def crop_resize(image, boxes, out_h: int, out_w: int, preserve_aspect: bool = True, *,
                device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Cut N boxes (xyxy [N, 4], page pixels) out of one float page
    ``image`` [H, W, C] and resize each to (out_h, out_w) on ``device``:
    the crop of :func:`crop_resize_pages` (each crop scaled so its height
    fits ``out_h``, the x step widened so a wide word squeezes) on values
    as given, white 1.0 past each crop's effective width (with
    ``preserve_aspect`` False every crop fills ``out_w``).  Returns (crops
    [N, out_h, out_w, C] float32, eff_w [N] int32), rounded as XLA's CPU
    backend rounds the JAX version."""
    dev = resolve_device(device)
    image = torch.as_tensor(image).to(dev, torch.float32)
    boxes = torch.as_tensor(boxes).to(dev, torch.float32)
    page_idx = torch.zeros(len(boxes), dtype=torch.int64, device=dev)
    crops, eff_w = _crop_sample(image[None], page_idx, boxes, out_h, out_w, 1.0,
                                preserve_aspect)
    return crops, eff_w.to(torch.int32)


def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """float32 [n_in, n_out] weights of ``jax.image.resize``'s linear
    kernel with antialiasing (``compute_weight_mat``): sample ``j`` sits at
    ``(j + 0.5) / scale - 0.5`` (``1 / scale`` rounded once from float64,
    as JAX computes it from Python floats, then one fused multiply-add);
    the triangle is widened by
    ``1 / scale`` when downscaling (the distance times the float32
    reciprocal of that width, as XLA folds the divide); each column is
    normalised to sum 1, and zeroed where its sample falls outside the
    input.  XLA's constant folding sums a column in its own order, so a
    weight may differ from JAX's by one ulp."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    # (j + 0.5) * inv_scale - 0.5 as one fused multiply-add, as XLA contracts it
    sample = ((np.arange(n_out, dtype=f32) + f32(0.5)).astype(np.float64) * np.float64(inv_scale)
              - 0.5).astype(f32)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) * (f32(1.0) / kernel_scale)
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x)).astype(f32)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize_linear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``jax.image.resize(x, (P, h, w, C), "linear")`` of NHWC ``x`` in
    its dtype: each axis one product with its :func:`resize_weights`
    matrix (antialiased when it downscales: the triangle widens to cover
    every input pixel, which ``F.interpolate`` does not do), rounded to
    the dtype, then the other, in the order ``jnp.einsum`` picks (fewer
    multiply-adds first; H on a tie).  JAX skips an axis whose size is
    unchanged; its matrix here is the identity, so the product is exact."""
    hi, wi = x.shape[1], x.shape[2]
    wh = torch.from_numpy(resize_weights(hi, h)).to(x.device, x.dtype)
    ww = torch.from_numpy(resize_weights(wi, w)).to(x.device, x.dtype)
    if hi * w * (wi + h) < h * wi * (hi + w):
        x = torch.einsum("phwc,wl->phlc", x, ww)
        return torch.einsum("phlc,hk->pklc", x, wh)
    x = torch.einsum("phwc,hk->pkwc", x, wh)
    return torch.einsum("pkwc,wl->pklc", x, ww)


def resize_page(image, target_h: int, target_w: int, *, device="cuda") -> torch.Tensor:
    """``jax.image.resize(image, (target_h, target_w, C), "bilinear")`` of
    an [H, W, C] page on ``device``, float32: :func:`resize_linear` of the
    page."""
    x = torch.as_tensor(image).to(resolve_device(device), torch.float32)
    return resize_linear(x[None], target_h, target_w)[0]


def prepare_page(img_u8, bucket_h: int, bucket_w: int, scale: float = 1.0, *,
                 device="cuda") -> Dict[str, torch.Tensor]:
    """The page graph of a uint8 page (already padded on the host to its
    bucket, ``bucket_h`` x ``bucket_w``) on ``device``: {``rgb``: [H, W, 3]
    float32 in [0, 1], ``gray``: its luma [H, W], ``ink``: Otsu's ink mask
    [H, W] bool}.  ``scale`` is accepted as the JAX version accepts it,
    and unused there too."""
    rgb = normalize_page(torch.as_tensor(img_u8).to(resolve_device(device)))
    gray = to_grayscale(rgb)
    return {"rgb": rgb, "gray": gray, "ink": otsu_binarize(gray)}


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
    chans = pages.shape[3:]  # () or (C,)
    crops, eff_w = _crop_sample(pages, page_idx, boxes, out_h, out_w, 255.0)
    if not channel_mean:
        return crops * (1.0 / 255.0), eff_w.to(torch.int32)
    if chans not in ((), (3,)):
        raise ValueError(f"a channel mean takes 1 or 3 channels, got {chans}")
    v = crops.unbind(-1) if chans else (crops,) * 3
    s = torch.tensor(1.0 / 255.0, dtype=torch.float32, device=dev)
    total = fma(v[2], s, fma(v[1], s, v[0] * s))
    return total * (1.0 / 3.0), eff_w.to(torch.int32)
