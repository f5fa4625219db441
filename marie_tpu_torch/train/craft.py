"""CRAFT detector training with synthetic page supervision (port of
``marie_tpu/train/craft.py``).

Every rendered word's box is known, so the region target is the
(slightly shrunk) word-box mask and the affinity target bridges the gaps
between horizontally adjacent words of a line.  Pages are drawn with the
glyph atlas (:mod:`marie_tpu_torch.utils.glyphs`) and PIL's resize in
numpy; :func:`render_page_with_targets` makes the JAX function's
``numpy.random.Generator`` calls in the same order, so a generator state
gives the same words, boxes and targets, and the page PIL draws.

:func:`train_craft_device` keeps the pages and targets on the device as
uint8 and draws each step's pages and noise there; BatchNorm runs in
training mode with flax's batch statistics and running-statistics update
(``train/batchnorm.py``); the loss is the weighted MSE ``mean((1 + 9 t)
(out - t)^2)``, stepped by the clip at 1.0 and AdamW (weight decay 1e-4)
on a warmup + cosine schedule, float32 without TF32.
"""

import time
from typing import Optional, Tuple

import numpy as np
import torch

from marie_tpu_torch.logging_core import MarieLogger
from marie_tpu_torch.models.configs import CraftConfig
from marie_tpu_torch.registry.checkpoints import save_params
from marie_tpu_torch.registry.convert import to_flax
from marie_tpu_torch.train import batchnorm
from marie_tpu_torch.train.loop import StepTrainer, init_module
from marie_tpu_torch.train.optim import warmup_cosine_decay_schedule
from marie_tpu_torch.train.recognizer import add_noise, draw_indices
from marie_tpu_torch.utils import pil_ops
from marie_tpu_torch.utils.device import float32_precision
from marie_tpu_torch.utils.glyphs import load_font

_PAGE_WORDS = (
    "invoice total amount payment due net terms claim policy member "
    "provider service balance statement account number date reference "
    "name address phone code group plan 2024 1500 375.20 11/02/2023"
).split()
#: four families, in the JAX font-file order: detection trained on Sans
#: alone clipped serif ascenders
PAGE_FACES = ("DejaVuSans", "DejaVuSans-Bold", "DejaVuSerif", "DejaVuSansMono")


def render_page_with_targets(
    rng: np.random.Generator,
    page_hw: Tuple[int, int] = (512, 384),
    font_sizes: Tuple[int, ...] = (14, 18, 22, 26),
    out_stride: int = 2,
    dense_p: float = 0.35,
) -> Tuple[np.ndarray, np.ndarray]:
    """-> (page uint8 [H,W,3], targets uint8 [H/s,W/s,2] in 0..255).

    With probability ``dense_p`` the page renders in DENSE layout: two
    tight columns, small font (12-16), 4-12px word gaps and lines that
    nearly touch."""
    h, w = page_hw
    words = _PAGE_WORDS
    fonts = [load_font(face, s) for face in PAGE_FACES for s in font_sizes]

    img = np.full((h, w), 255, np.uint8)
    region = np.zeros((h // out_stride, w // out_stride), np.float32)
    affinity = np.zeros((h // out_stride, w // out_stride), np.float32)

    dense = rng.random() < dense_p
    if dense:
        # one face and size a page; columns split the page with a gutter
        fs = int(rng.choice((12, 14, 16)))
        page_fonts = [load_font(face, fs) for face in PAGE_FACES]
        dense_font = page_fonts[int(rng.integers(0, len(page_fonts)))]
        n_cols = 2 if rng.random() < 0.7 else 1
        gutter = int(rng.integers(12, 25))
        col_w = (w - (n_cols + 1) * gutter) // n_cols
        col_ranges = [
            (gutter + c * (col_w + gutter), gutter + c * (col_w + gutter) + col_w)
            for c in range(n_cols)
        ]
        word_gap = (3, 13)       # 4-12px inclusive of jitter
        line_gap = (2, 7)        # y += fs + U[2,6]
    else:
        word_gap = (10, 40)

    def _place_words(x_start, x_end, y, font):
        x = x_start
        prev_box = None
        while x < x_end:
            text = str(rng.choice(words))
            font.draw_text(img, (x, y), text, fill=0)
            bx = font.textbbox((x, y), text)
            if dense and bx[2] > x_end:
                # dense columns: a word past the column is blanked out
                # (PIL's rectangle takes both corners inclusive)
                img[max(bx[1], 0):max(bx[3] + 1, 0), max(bx[0], 0):max(bx[2] + 1, 0)] = 255
                break
            # region: the word box shrunk 10% a side horizontally and 5%
            # vertically in page pixels before the heatmap grid
            px0, py0, px1, py1 = bx
            sxp = max((px1 - px0) // 10, 2)
            syp = max((py1 - py0) // 20, 1)
            x0 = (px0 + sxp) // out_stride
            y0 = (py0 + syp) // out_stride
            x1 = max((px1 - sxp) // out_stride, x0 + 1)
            y1 = max((py1 - syp) // out_stride, y0 + 1)
            region[y0:y1, x0:x1] = 1.0
            # affinity: bridge only the gap between unshrunk edges, so the
            # shrink margins keep a moat between words and the line band
            ux0 = px0 // out_stride
            ux1 = -(-px1 // out_stride)
            if prev_box is not None:
                q_ux1 = prev_box[2]
                ay0 = max(y0, prev_box[0])
                ay1 = min(y1, prev_box[1])
                if ay1 > ay0 and ux0 > q_ux1:
                    affinity[ay0:ay1, q_ux1:ux0] = 1.0
            prev_box = (y0, y1, ux1)
            x = bx[2] + int(rng.integers(*word_gap))

    if dense:
        for cx0, cx1 in col_ranges:
            y = int(rng.integers(10, 30))
            fs = dense_font.size
            while y < h - fs - 10:
                _place_words(cx0, cx1, y, dense_font)
                y += fs + int(rng.integers(*line_gap))
    else:
        y = int(rng.integers(10, 40))
        while y < h - 40:
            font = fonts[int(rng.integers(0, len(fonts)))]
            _place_words(int(rng.integers(10, 40)), w - 80, y, font)
            y += int(rng.integers(26, 44))

    page = img
    # resolution augmentation (25%): the page only; the targets stay
    if rng.random() < 0.25:
        f = float(rng.uniform(0.5, 0.75))
        small = pil_ops.resize_bilinear(img, (max(1, int(w * f)), max(1, int(h * f))))
        page = pil_ops.resize_bilinear(small, (w, h))
    targets = (np.stack([region, affinity], axis=-1) * 255).astype(np.uint8)
    return np.repeat(page[:, :, None], 3, axis=2), targets


def render_pages(rng: np.random.Generator, n: int, page_hw: Tuple[int, int], out_stride: int):
    """``n`` pages and targets of one generator, stacked."""
    pages, targets = zip(*(render_page_with_targets(rng, page_hw, out_stride=out_stride)
                           for _ in range(n)))
    return np.stack(pages), np.stack(targets)


def craft_loss(model):
    """The step's loss: ``loss_fn(images, targets)``, the weighted MSE with
    text pixels (sparse) weighted up."""

    def loss_fn(images, targets):
        out = model(images)
        weight = 1.0 + 9.0 * targets
        return (weight * (out - targets) ** 2).mean()

    return loss_fn


def craft_step(trainer: StepTrainer, model, images, targets):
    """One step: forward with batch statistics, AdamW on the parameters,
    then flax's running-statistics update from the step's batch."""
    loss = trainer.step(images, targets)
    batchnorm.update_running_statistics(model)
    return loss


def train_craft_device(
    config: Optional[CraftConfig] = None,
    steps: int = 4000,
    batch_size: int = 4,
    dataset_size: int = 256,
    page_hw: Tuple[int, int] = (512, 384),
    learning_rate: float = 5e-4,
    steps_per_dispatch: int = 25,
    refresh_every: int = 1000,
    seed: int = 0,
    checkpoint_path: Optional[str] = None,
    *,
    device="cuda",
    init_params=None,
    timing: Optional[dict] = None,
    losses: Optional[list] = None,
    batch_indices=None,
    batch_noise=None,
    dtype: torch.dtype = torch.float32,
):
    """Device-resident training on ``dataset_size`` rendered pages (seed
    ``seed``, re-rendered with ``seed + 1 + step`` every ``refresh_every``
    steps); each step adds Gaussian noise of a per-page sigma in [0,
    0.08).  ``init_params`` warm-starts from a flax-layout tree (params
    and batch_stats).  ``timing``, ``losses``, ``batch_indices`` and
    ``batch_noise`` (here the noise already scaled by each page's sigma)
    as in ``train_recognizer_device``.  ``dtype`` is the model's and the
    batches' (float64 holds the loop to a float64 reference: the float32
    batch statistics are ill-conditioned).  Returns (model, variables):
    the flax-layout tree."""
    logger = MarieLogger("train-craft")
    config = config or CraftConfig.base()

    model = init_module(config, None, seed, init_params, device).to(dtype).train()
    dev = next(model.parameters()).device

    def upload(block_seed):
        pages, targets = render_pages(np.random.default_rng(block_seed), dataset_size, page_hw,
                                      config.out_stride)
        return torch.from_numpy(pages).to(dev), torch.from_numpy(targets).to(dev)

    logger.info(f"rendering {dataset_size} training pages...")
    t0 = time.time()
    data_pages, data_targets = upload(seed)
    logger.info(f"rendered+uploaded in {time.time() - t0:.1f}s")

    warmup = max(steps // 10, 1)
    schedule = warmup_cosine_decay_schedule(0.0, learning_rate, warmup, steps)
    trainer = StepTrainer(model, craft_loss(model), schedule, weight_decay=1e-4, clip_norm=1.0)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)

    def batch(step):
        idx = draw_indices(gen, dataset_size, batch_size, dev, batch_indices, step)
        images = data_pages[idx].to(dtype) / 255.0
        sigma = None
        if batch_noise is None:
            sigma = torch.rand((batch_size, 1, 1, 1), generator=gen, device=dev) * 0.08
        images = add_noise(images, sigma, gen, batch_noise, step)
        return images, data_targets[idx].to(dtype) / 255.0

    batchnorm.use_batch_statistics(model)
    done = 0
    next_refresh = refresh_every
    try:
        while done < steps:
            if refresh_every and done >= next_refresh:
                data_pages, data_targets = upload(seed + 1 + done)
                next_refresh += refresh_every
                logger.info(f"dataset refreshed at step {done}")
            n = min(steps_per_dispatch, steps - done)
            with trainer.timed(dev):
                block = [craft_step(trainer, model, *batch(done + i)) for i in range(n)]
                mean_loss = float(torch.stack(block).mean())
            if losses is not None:
                losses.extend(float(v) for v in block)
            done += n
            if done % 250 == 0 or done == steps:
                logger.info(f"step {done}/{steps} loss={mean_loss:.5f} "
                            f"({trainer.seconds / done:.3f}s/step)")
    finally:
        batchnorm.restore(model)
    model.eval()
    variables = to_flax(model)
    if checkpoint_path:
        save_params(variables, checkpoint_path)
        logger.info(f"saved checkpoint to {checkpoint_path}")
    if timing is not None:
        timing.update(trainer.timing())
    return model, variables


@torch.no_grad()
def craft_heldout_loss(model, pages: np.ndarray, targets: np.ndarray,
                       batch_size: int = 8) -> float:
    """The weighted MSE of ``model`` (eval mode: running statistics) on
    held-out pages and targets, float32 without TF32; the mean over the
    pages of each page's mean, as one batch's mean gives it."""
    from marie_tpu_torch.utils.device import float32_precision

    p = next(model.parameters())
    total = 0.0
    with float32_precision(False):
        for s in range(0, len(pages), batch_size):
            x = torch.from_numpy(pages[s:s + batch_size]).to(p.device, torch.float32) / 255.0
            t = torch.from_numpy(targets[s:s + batch_size]).to(p.device, torch.float32) / 255.0
            out = model(x)
            per_page = ((1.0 + 9.0 * t) * (out - t) ** 2).mean(dim=(1, 2, 3))
            total += float(per_page.sum())
    return total / len(pages)
