"""OverlayProcessor — document cleanup / form-overlay removal (port of
``marie_tpu/overlay/overlay.py``).

``segment_frame(key, frame)`` returns ``(real, mask, clean)``: the
original, the detected overlay mask and the cleaned page.
``segment_batch(frames)`` cleans same-shape grayscale pages in chunks
(the extract pipeline's path): the pix2pix generator
(:mod:`marie_tpu_torch.models.pix2pix`, cuDNN on the card), the overlay
mask ``mean_c |fake - x| > 0.15``, and the dark-text blend that keeps
the page's own dark pixels outside the mask.  The generator runs in
bfloat16 by default (every float leaf cast, as the JAX version casts
its variables) at half the page's resolution (``gan_scale`` 2); the mask
and the blend are float32 at full resolution.

What must match the JAX version:

* ``u8 / 127.5 - 1`` as XLA computes it: one fused multiply-add with the
  float32 reciprocal (a 256-entry table here);
* ``jax.image.resize(..., "linear")`` antialiases by default: the 2x
  downscale is a triangle filter widened to 4 taps ([1, 3, 3, 1] / 8,
  renormalised at the edges), the 2x upscale half-pixel bilinear.  Both
  are JAX's weight matrices applied one axis at a time in the compute
  dtype, in ``jnp.einsum``'s order (``preprocess/ops.py::resize_linear``);
* the host resizes of oversize pages are cv2's ``INTER_AREA``,
  ``INTER_LINEAR`` and ``INTER_NEAREST`` in numpy
  (:mod:`marie_tpu_torch.preprocess.resize`).

With no tree given, the processor loads ``pix2pix-synth`` from the
port's zoo (``torch_zoo/``) and, where the zoo lacks it, draws
``Pix2PixConfig()`` at full width from a seed (``trained`` False).
Host threads get numpy arrays back; no CUDA tensor leaves a call.
"""

import os
from typing import Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from marie_tpu_torch.logging_core import MarieLogger
from marie_tpu_torch.models.configs import Pix2PixConfig
from marie_tpu_torch.preprocess.buckets import BucketSpec, pad_to
from marie_tpu_torch.preprocess.ops import resize_linear
from marie_tpu_torch.preprocess.resize import (
    resize_area_u8,
    resize_linear_u8,
    resize_nearest_u8,
)
from marie_tpu_torch.utils.device import float32_precision, resolve_device

#: the zoo tree the processor loads when given none
ZOO_TREE = "pix2pix-synth"
#: the seed of the full-width generator drawn when the zoo lacks the tree
SEED = 0
#: |fake - x| averaged over channels above this marks an overlay pixel
MASK_THRESHOLD = 0.15
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _unit_table() -> torch.Tensor:
    """float32 ``v / 127.5 - 1`` for v in 0..255, rounded as XLA rounds
    it: ``fma(v, float32(1 / 127.5), -1)``."""
    v = np.arange(256, dtype=np.float64)
    return torch.from_numpy((v * np.float64(np.float32(1.0 / 127.5)) - 1.0).astype(np.float32))


def _segment_batch_gray(model, unit, pages: torch.Tensor, gan_scale: int):
    """[P, H, W] uint8 on the device -> (mask [P, H, W] uint8 0/255, the
    blended gray page [P, H, W] uint8) (``_segment_batch_gray_jit``):
    generator, mask, dark-text blend and the channel mean, all on the
    device."""
    dtype = next(model.parameters()).dtype
    x = unit[pages.long()]  # [P, H, W] float32 in [-1, 1]
    x3 = x[..., None].expand(*x.shape, 3).to(dtype)
    if gan_scale > 1:
        p, hh, ww = pages.shape
        small = resize_linear(x3, hh // gan_scale, ww // gan_scale)
        fake = resize_linear(model(small), hh, ww).float()
    else:
        # the generator's output feeds float32 ops only: XLA leaves it
        # unrounded (excess precision), and so does this path
        fake = model(x3, out_dtype=torch.float32)
    clean = torch.clamp((fake + 1.0) * 127.5, 0, 255).to(torch.uint8)
    mask = (fake - x[..., None]).abs().mean(dim=-1) > MASK_THRESHOLD
    real = pages.float()
    keep = (real < 128.0) & ~mask
    blended3 = torch.where(keep[..., None], real[..., None], clean.float())
    blended = torch.clamp(blended3.mean(dim=-1), 0, 255).to(torch.uint8)
    return mask.to(torch.uint8) * 255, blended


def _segment_page(model, unit, page: torch.Tensor):
    """[H, W, 3] uint8 on the device -> (mask [H, W] uint8 0/1, blended
    [H, W, 3] uint8): ``_segment_jit`` then ``_blend_to_text_jit``."""
    x = unit[page.long()]
    fake = model(x[None])[0].float()
    clean = torch.clamp((fake + 1.0) * 127.5, 0, 255).to(torch.uint8)
    mask = (fake - x).abs().mean(dim=-1) > MASK_THRESHOLD
    real = page.float()
    keep = ((real.mean(dim=-1) < 128.0) & ~mask)[..., None]
    blended = torch.clamp(torch.where(keep, real, clean.float()), 0, 255).to(torch.uint8)
    return mask.to(torch.uint8), blended


class OverlayProcessor:
    def __init__(
        self,
        config: Optional[Pix2PixConfig] = None,
        variables=None,
        bucket_spec: Optional[BucketSpec] = None,
        compute_dtype: str = "bfloat16",
        gan_scale: int = 2,
        device="cuda",
    ):
        from marie_tpu_torch.registry.convert import init_flax_layout, load_model
        from marie_tpu_torch.registry.zoo import zoo_params

        self.device = resolve_device(device)
        if compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype is one of {tuple(_DTYPES)}, got {compute_dtype!r}")
        self.compute_dtype = compute_dtype
        self.gan_scale = int(gan_scale)
        self.logger = MarieLogger("OverlayProcessor")
        self.trained = variables is not None
        if variables is None and config is None:
            variables = zoo_params(ZOO_TREE)
            if variables is not None:
                config = Pix2PixConfig.synth()
                self.trained = True
        self.config = config or Pix2PixConfig()
        if variables is None:
            variables = init_flax_layout(self.config, SEED)
        self.buckets = bucket_spec or BucketSpec()
        self.models = {"float32": load_model(self.config, variables, self.device)}
        self.models["bfloat16"] = load_model(self.config, variables, self.device,
                                             dtype=torch.bfloat16)
        self._unit = _unit_table().to(self.device)
        #: generator forwards run (one per chunk or page), for callers
        #: that check a stage was skipped
        self.calls = 0

    def _forward(self, fn, dtype: str, *args):
        self.calls += 1
        # full float32 convolutions, whatever torch's TF32 switches say
        with torch.inference_mode(), float32_precision(False), record_function("marie.overlay"):
            return fn(self.models[dtype], self._unit, *args)

    def segment_frame(
        self, key: str, frame: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Returns (real, mask, clean) at the original page size; the
        generator runs in float32 on a 3-channel copy padded to multiples
        of 8, and a 2-D frame's cleaned page comes back 2-D."""
        gray_in = frame.ndim == 2
        h, w = frame.shape[:2]
        (_, _), scale = self.buckets.fit_with_scale(h, w)
        work = np.stack([frame] * 3, axis=-1) if gray_in else frame
        if scale < 1.0:
            work = resize_area_u8(work, (int(w * scale), int(h * scale)))
        wh, ww = work.shape[:2]
        padded = pad_to(work, (wh + 7) // 8 * 8, (ww + 7) // 8 * 8)
        page = torch.from_numpy(np.ascontiguousarray(padded)).to(self.device)
        mask_d, blended_d = self._forward(_segment_page, "float32", page)
        mask = (mask_d.cpu().numpy() * 255).astype(np.uint8)[:wh, :ww]
        blended = blended_d.cpu().numpy()[:wh, :ww]
        if scale < 1.0:
            mask = resize_nearest_u8(mask, (w, h))
            blended = resize_linear_u8(blended, (w, h))
        if gray_in:
            blended = blended.mean(axis=-1)
        return frame, mask, blended.astype(np.uint8)

    @staticmethod
    def overlay_scores(frames) -> list:
        """Cheap host-side dirtiness score per page: (colored_fraction,
        midtone_fraction) on a 4x subsample.  Form overlays are colored
        rules, boxes, stamps or gray shaded fills; a clean printed page is
        near-black glyphs on near-white background with only antialiasing
        in between (~1% midtones)."""
        scores = []
        for f in frames:
            s = np.asarray(f)[::4, ::4]
            if s.ndim == 3:
                mx = s.max(axis=-1).astype(np.int16)
                mn = s.min(axis=-1).astype(np.int16)
                colored = float((mx - mn > 24).mean())
                gray = s.mean(axis=-1)
            else:
                colored = 0.0
                gray = s
            mid = float(((gray > 90) & (gray < 220)).mean())
            scores.append((colored, mid))
        return scores

    def segment_batch(
        self, frames, chunk: int = 4, compute_dtype: Optional[str] = None, gate: str = "auto"
    ) -> list:
        """Clean a list of grayscale pages: ``[clean_u8 [H, W], ...]``.
        Same-shape 2-D pages go through the generator in ``chunk``-page
        groups (the tail padded with white pages); mixed shapes and RGB
        pages go through :meth:`segment_frame` one by one.

        ``gate="auto"`` (``MARIE_OVERLAY_GATE=off`` disables) passes pages
        with no overlay signature (:meth:`overlay_scores`) through
        unchanged."""
        same_2d = frames and all(f.ndim == 2 and f.shape == frames[0].shape for f in frames)
        if not same_2d:
            return [self.segment_frame(f"b{i}", f)[2] for i, f in enumerate(frames)]
        if gate == "auto" and os.environ.get("MARIE_OVERLAY_GATE") != "off":
            flags = [colored > 0.001 or mid > 0.03
                     for colored, mid in self.overlay_scores(frames)]
            if not all(flags):
                out = [np.asarray(f) for f in frames]
                dirty_idx = [i for i, d in enumerate(flags) if d]
                if dirty_idx:
                    cleaned = self.segment_batch([frames[i] for i in dirty_idx], chunk=chunk,
                                                 compute_dtype=compute_dtype, gate="off")
                    for i, c in zip(dirty_idx, cleaned):
                        out[i] = c
                return out
        h, w = frames[0].shape
        (_, _), scale = self.buckets.fit_with_scale(h, w)
        work = list(frames)
        if scale < 1.0:
            work = [resize_area_u8(f, (int(w * scale), int(h * scale))) for f in work]
        wh, ww = work[0].shape
        bh, bw = (wh + 7) // 8 * 8, (ww + 7) // 8 * 8
        n_pad = -len(work) % chunk
        batch = np.full((len(work) + n_pad, bh, bw), 255, np.uint8)
        batch[:len(work), :wh, :ww] = np.stack(work)
        dtype = compute_dtype or self.compute_dtype
        pages = torch.from_numpy(batch).to(self.device)
        # every chunk is queued before the one copy back
        outs = [self._forward(_segment_batch_gray, dtype, pages[s:s + chunk], self.gan_scale)[1]
                for s in range(0, len(batch), chunk)]
        blended = torch.cat(outs).cpu().numpy()[:len(work), :wh, :ww]
        if scale < 1.0:
            blended = np.stack([resize_linear_u8(b, (w, h)) for b in blended])
        return [b for b in blended]

    def segment(self, document_id: str, frames) -> list:
        """``segment_frame`` of every frame."""
        return [self.segment_frame(f"{document_id}_{i}", f) for i, f in enumerate(frames)]
