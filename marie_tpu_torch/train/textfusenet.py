"""TextFuseNet training on synthetic pages with char-level supervision (port
of ``marie_tpu/train/textfusenet.py``).

The renderer knows every word box and every character box (cumulative
advances, ``GlyphFont.getlength``), so the targets come free: word region
and affinity (the CRAFT formulation), character centres, and the global
text segmentation, at stride 2 and max-pooled to the head's stride 4 on
the device.  The refinement loss runs the fuse module on each page's
jittered word boxes (positives: the delta target recovers the word box)
and shifted ones (negatives, off text), with the page's character boxes.

As in the JAX trainer the model runs with ``train=False`` while every leaf
of its variables steps: the BatchNorm running statistics are constants
of the forward that the loss differentiates and AdamW updates
(``train/batchnorm.py::train_running_statistics``).  Float32 without
TF32; clip at 1.0 and AdamW (weight decay 1e-4) on a warmup + cosine
schedule.
"""

import time
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from marie_tpu_torch.logging_core import MarieLogger
from marie_tpu_torch.models.configs import TextFuseNetConfig
from marie_tpu_torch.preprocess.ops import fma, normalize_page
from marie_tpu_torch.registry.checkpoints import save_params
from marie_tpu_torch.registry.convert import to_flax
from marie_tpu_torch.train import batchnorm
from marie_tpu_torch.train.craft import _PAGE_WORDS, PAGE_FACES
from marie_tpu_torch.train.loop import StepTrainer, init_module
from marie_tpu_torch.train.optim import warmup_cosine_decay_schedule
from marie_tpu_torch.train.recognizer import draw_indices
from marie_tpu_torch.utils.glyphs import load_font


def render_page_tfn(
    rng: np.random.Generator,
    page_hw: Tuple[int, int] = (512, 384),
    font_sizes: Tuple[int, ...] = (14, 18, 22, 26),
    max_words: int = 128,
    max_chars: int = 512,
):
    """-> (page u8 [H, W, 3], targets u8 [H/2, W/2, 4], word_boxes f32
    [K, 4], word_valid bool [K], char_boxes f32 [M, 4], char_valid bool
    [M]): the JAX renderer's draws, in its order.

    Target channels: word region, word affinity, char centers, seg mask.
    Boxes are xyxy in full-page pixels."""
    h, w = page_hw
    fonts = [load_font(face, s) for face in PAGE_FACES for s in font_sizes]

    img = np.full((h, w), 255, np.uint8)
    t = np.zeros((h // 2, w // 2, 4), np.float32)
    wboxes, cboxes = [], []

    y = int(rng.integers(10, 40))
    while y < h - 40:
        x = int(rng.integers(10, 40))
        font = fonts[int(rng.integers(0, len(fonts)))]
        prev_box = None
        while x < w - 80:
            text = str(rng.choice(_PAGE_WORDS))
            font.draw_text(img, (x, y), text, fill=0)
            bx = font.textbbox((x, y), text)
            wboxes.append([bx[0], bx[1], bx[2], bx[3]])
            x0, y0, x1, y1 = (v // 2 for v in bx)
            sx, sy = max((x1 - x0) // 10, 1), max((y1 - y0) // 10, 1)
            t[y0 + sy:y1 - sy, x0 + sx:x1 - sx, 0] = 1.0  # word region
            if prev_box is not None:
                px1 = prev_box[2]
                ay0 = max(y0 + sy, prev_box[1])
                ay1 = min(y1 - sy, prev_box[3])
                if ay1 > ay0 and x0 > px1:
                    t[ay0:ay1, px1:x0, 1] = 1.0  # affinity
            prev_box = (x0, y0, x1, y1)
            t[y0:y1, x0:x1, 3] = 1.0  # seg mask
            # per-character boxes from cumulative advances
            off = 0.0
            for ch in text:
                adv = font.getlength(ch)
                cx0, cx1 = bx[0] + off, bx[0] + off + adv
                off += adv
                if adv < 1:
                    continue
                cboxes.append([cx0, bx[1], cx1, bx[3]])
                gx0, gx1 = int(cx0) // 2, int(cx1) // 2
                gy0, gy1 = y0, y1
                csx = max((gx1 - gx0) // 4, 0)
                csy = max((gy1 - gy0) // 4, 1)
                t[gy0 + csy:gy1 - csy, gx0 + csx:max(gx1 - csx, gx0 + 1), 2] = 1.0  # centers
            x = bx[2] + int(rng.integers(10, 40))
        y += int(rng.integers(26, 44))

    def _pad(arr, n):
        a = np.zeros((n, 4), np.float32)
        v = np.zeros((n,), bool)
        k = min(len(arr), n)
        if k:
            a[:k] = np.asarray(arr[:k], np.float32)
            v[:k] = True
        return a, v

    wb, wv = _pad(wboxes, max_words)
    cb, cv = _pad(cboxes, max_chars)
    return np.repeat(img[:, :, None], 3, axis=2), (t * 255).astype(np.uint8), wb, wv, cb, cv


def render_dataset(seed: int, n: int, page_hw: Tuple[int, int], max_words: int,
                   max_chars: int):
    """``n`` pages of the seed's generator, each of the six arrays of
    :func:`render_page_tfn` stacked."""
    rng = np.random.default_rng(seed)
    pages = [render_page_tfn(rng, page_hw, max_words=max_words, max_chars=max_chars)
             for _ in range(n)]
    return [np.stack(a) for a in zip(*pages)]


def _bce(pred, target, eps: float = 1e-6):
    p = torch.clamp(pred, eps, 1 - eps)
    return -(target * torch.log(p) + (1 - target) * torch.log(1 - p)).mean()


def _sigmoid_bce(logits, labels):
    """``optax.sigmoid_binary_cross_entropy``."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


def tfn_loss(model):
    """The step's loss: ``loss_fn(images, t_head, t_seg4, wb, wv, cb, cv,
    jitter, shift)``, with each page's box jitter [B, K, 4] in [-0.15,
    0.15) of the box's size and negative shift [B, K, 2] in [40, 120) px:
    the dense BCE terms, the stride-4 segmentation and the refinement
    through :meth:`TextFuseNet.fuse` page by page."""

    def loss_fn(images, t_head, t_seg4, wb, wv, cb, cv, jitter, shift):
        out = model.dense(images)
        l_word = _bce(out["word"][..., 0], t_head[..., 0]) + _bce(out["word"][..., 1],
                                                                   t_head[..., 1])
        l_char = _bce(out["char"][..., 0], t_head[..., 2])
        # the global seg branch stays at stride 4 whatever the heads' stride
        l_seg = _sigmoid_bce(out["seg_logits"][..., 0], t_seg4).mean()
        k = wb.shape[1]
        use_neg = torch.arange(k, device=wb.device) >= k // 2
        l_scores, l_boxes = [], []
        for i in range(images.shape[0]):
            wb_i, wv_i = wb[i], wv[i]
            bw = wb_i[:, 2] - wb_i[:, 0]
            bh = wb_i[:, 3] - wb_i[:, 1]
            pos = fma(jitter[i], torch.stack([bw, bh, bw, bh], dim=-1), wb_i)
            neg = wb_i + torch.cat([shift[i], shift[i]], dim=-1)
            cand = torch.where(use_neg[:, None], neg, pos) / 4.0  # grid coordinates
            score, refined = model.fuse(out["p3"][i], out["seg_feat"][i], cand, wv_i,
                                        cb[i] / 4.0, cv[i])
            valid = wv_i.to(score.dtype)
            lbl = torch.where(use_neg, 0.0, 1.0) * valid
            logit = (torch.log(torch.clamp(score, 1e-6, 1 - 1e-6))
                     - torch.log(torch.clamp(1 - score, 1e-6, 1 - 1e-6)))
            l_scores.append((_sigmoid_bce(logit, lbl) * valid).sum()
                            / torch.clamp(valid.sum(), min=1.0))
            # box regression on the positives only: recover the word box
            pos_mask = (~use_neg & wv_i).to(score.dtype)
            l_boxes.append(((refined - wb_i / 4.0).abs().mean(-1) * pos_mask).sum()
                           / torch.clamp(pos_mask.sum(), min=1.0))
        l_fuse = torch.stack(l_scores).mean() + 0.2 * torch.stack(l_boxes).mean()
        return l_word + l_char + l_seg + l_fuse

    return loss_fn


def train_textfusenet_device(
    config: Optional[TextFuseNetConfig] = None,
    steps: int = 2000,
    batch_size: int = 4,
    dataset_size: int = 128,
    page_hw: Tuple[int, int] = (512, 384),
    learning_rate: float = 3e-4,
    steps_per_dispatch: int = 25,
    seed: int = 0,
    checkpoint_path: Optional[str] = None,
    *,
    device="cuda",
    init_params=None,
    timing: Optional[dict] = None,
    losses: Optional[list] = None,
    batch_indices=None,
    batch_jitter=None,
    batch_shift=None,
):
    """Device-resident training on ``dataset_size`` pages of seed ``seed``.
    ``init_params`` warm-starts from a flax-layout tree (params and
    batch_stats); ``timing``, ``losses`` and ``batch_indices`` as in
    ``train_recognizer_device`` (the render rate in
    ``timing["pages_per_s"]``); ``batch_jitter`` and ``batch_shift``
    replace each step's draws ([B, K, 4], [B, K, 2]).  Returns (model,
    variables): the flax-layout tree."""
    logger = MarieLogger("train-textfusenet")
    cfg = config or TextFuseNetConfig.synth()
    k, m = cfg.max_words, cfg.max_chars
    model = init_module(cfg, None, seed, init_params, device)
    dev = next(model.parameters()).device

    logger.info(f"rendering {dataset_size} pages at {page_hw}...")
    t0 = time.perf_counter()
    arrays = render_dataset(seed, dataset_size, page_hw, k, m)
    render_s = time.perf_counter() - t0
    pages, targets, wb, wv, cb, cv = (torch.from_numpy(a).to(dev) for a in arrays)
    logger.info(f"rendered+uploaded in {time.perf_counter() - t0:.1f}s")

    warmup = max(steps // 10, 1)
    schedule = warmup_cosine_decay_schedule(0.0, learning_rate, warmup, steps)
    params = list(model.parameters()) + batchnorm.train_running_statistics(model)
    trainer = StepTrainer(model, tfn_loss(model), schedule, weight_decay=1e-4, clip_norm=1.0,
                          params=params)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)

    def given(arrays, step):
        return torch.as_tensor(np.asarray(arrays[step]), dtype=torch.float32, device=dev)

    def batch(step):
        idx = draw_indices(gen, dataset_size, batch_size, dev, batch_indices, step)
        images = normalize_page(pages[idx])
        t2 = normalize_page(targets[idx])
        t4 = F.max_pool2d(t2.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        # the sub-pixel head trains on the native stride-2 targets
        t_head = t2 if cfg.head_stride == 2 else t4
        if batch_jitter is None:
            jitter = -0.15 + 0.3 * torch.rand((batch_size, k, 4), generator=gen, device=dev)
        else:
            jitter = given(batch_jitter, step)
        if batch_shift is None:
            shift = 40.0 + 80.0 * torch.rand((batch_size, k, 2), generator=gen, device=dev)
        else:
            shift = given(batch_shift, step)
        return images, t_head, t4[..., 3], wb[idx], wv[idx], cb[idx], cv[idx], jitter, shift

    done = 0
    try:
        while done < steps:
            n = min(steps_per_dispatch, steps - done)
            with trainer.timed(dev):
                block = [trainer.step(*batch(done + i)) for i in range(n)]
                mean_loss = float(torch.stack(block).mean())
            if losses is not None:
                losses.extend(float(v) for v in block)
            done += n
            logger.info(f"step {done}/{steps} loss={mean_loss:.4f} "
                        f"({trainer.seconds:.0f}s)")
    finally:
        batchnorm.restore(model)
    model.eval()
    variables = to_flax(model)
    if checkpoint_path:
        save_params(variables, checkpoint_path)
        logger.info(f"saved checkpoint -> {checkpoint_path}")
    if timing is not None:
        timing.update(trainer.timing(), pages_per_s=dataset_size / render_s)
    return model, variables
