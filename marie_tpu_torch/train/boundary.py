"""Boundary-registration training (port of ``marie_tpu/train/boundary.py``):
regress the page quad inside synthetic scans (skew, offset, scale,
perspective jitter, dark and noisy backgrounds).

The pages are rendered once on the host (:func:`~marie_tpu_torch.train.
craft.render_page_with_targets`, the JAX renderer's draws) and kept on the
device as uint8; each step draws its pages, quads, backgrounds and
per-pixel noise there from a ``torch.Generator`` (:func:`_sample_quad`,
:func:`_make_scan`) and composites the batch's scans with one batched
solve (:func:`~marie_tpu_torch.models.boundary.composite_scans`).  The
loss is the mean squared error of the corners normalised to the frame,
stepped by the clip at 1.0 and AdamW (weight decay 1e-4) on a warmup +
cosine schedule, float32 without TF32.  The port cannot repeat
``jax.random``: a test hands the JAX trainer's draws to
:func:`train_boundary_device` (``batch_indices``, ``batch_quads``,
``batch_noise``).
"""

import math
import time
from typing import Optional, Tuple

import numpy as np
import torch

from marie_tpu_torch.logging_core import MarieLogger
from marie_tpu_torch.models.boundary import composite_scans, quad_iou
from marie_tpu_torch.models.configs import BoundaryConfig
from marie_tpu_torch.preprocess.ops import normalize_page
from marie_tpu_torch.registry.checkpoints import save_params
from marie_tpu_torch.registry.convert import to_flax
from marie_tpu_torch.train.craft import render_page_with_targets
from marie_tpu_torch.train.loop import StepTrainer, init_module
from marie_tpu_torch.train.optim import warmup_cosine_decay_schedule
from marie_tpu_torch.train.recognizer import draw_indices
from marie_tpu_torch.utils.device import float32_precision


def _uniform(gen, shape, lo: float, hi: float, dev) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)


def _sample_quad(gen, n: int, canvas_hw: Tuple[int, int], dev):
    """``n`` random page quads inside the canvas ([n, 4, 2] xy, tl tr br
    bl) and background greys ([n]): rotation within 12 degrees, scale
    0.55-0.97 (serving sees near-full-frame scans), centred with a 4 px
    margin, each corner jittered by up to 2% of the canvas."""
    ch, cw = canvas_hw
    size = torch.tensor([cw, ch], dtype=torch.float32, device=dev)
    angle = _uniform(gen, (n,), -12.0, 12.0, dev) * (math.pi / 180.0)
    scale = _uniform(gen, (n,), 0.55, 0.97, dev)
    hw2 = size * scale[:, None] / 2.0  # [n, 2]
    base = torch.tensor([[-1.0, -1.0], [1.0, -1.0], [1.0, 1.0], [-1.0, 1.0]],
                        dtype=torch.float32, device=dev)[None] * hw2[:, None, :]
    c, s = torch.cos(angle), torch.sin(angle)
    rot = torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)  # [n, 2, 2]
    pts = base @ rot.transpose(1, 2)
    # keep the rotated quad inside the canvas with a small margin
    ext = pts.abs().amax(dim=1)  # [n, 2]
    lo = ext + 4.0
    hi = torch.maximum(size - ext - 4.0, lo + 1.0)
    pts = pts + (lo + torch.rand((n, 2), generator=gen, device=dev) * (hi - lo))[:, None, :]
    jitter = _uniform(gen, (n, 4, 2), -0.02, 0.02, dev) * size
    pts = torch.minimum(torch.clamp(pts + jitter, min=2.0), size - 3.0)
    bg = _uniform(gen, (n,), 15.0, 110.0, dev)
    return pts, bg


def _make_scan(gen, docs_u8: torch.Tensor, canvas_hw: Tuple[int, int], quads=None, noise=None):
    """Scans of the pages ``docs_u8`` [B, H, W, 3] uint8 and their quads:
    (uint8 [B, H, W, 3], float32 [B, 4, 2]).  The quads, backgrounds and
    the per-pixel noise in [-18, 18) are drawn from ``gen`` unless given
    (``quads`` a (quads, bg) pair)."""
    dev = docs_u8.device
    n = docs_u8.shape[0]
    if quads is None:
        quad, bg = _sample_quad(gen, n, canvas_hw, dev)
    else:
        quad, bg = (torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)
                    for a in quads)
    if noise is None:
        noise = _uniform(gen, (n, *canvas_hw), -18.0, 18.0, dev)
    else:
        noise = torch.as_tensor(np.asarray(noise), dtype=torch.float32, device=dev)
    return composite_scans(docs_u8, quad, canvas_hw, bg, noise), quad


def render_docs(seed: int, n: int, hw: Tuple[int, int]) -> np.ndarray:
    """``n`` clean pages [n, H, W, 3] uint8 of the seed's generator."""
    rng = np.random.default_rng(seed)
    return np.stack([render_page_with_targets(rng, hw)[0] for _ in range(n)])


def boundary_loss(model, norm: torch.Tensor):
    """The step's loss: ``loss_fn(scans_u8, quads)``, the mean squared
    error of the corners normalised to the frame (``norm``, [2] in the
    model's float type)."""

    def loss_fn(scans, quads):
        pred = model(normalize_page(scans).to(norm.dtype))
        target = (quads / norm).reshape(len(quads), 8)
        return ((pred - target) ** 2).mean()

    return loss_fn


def train_boundary_device(
    config: Optional[BoundaryConfig] = None,
    steps: int = 3000,
    batch_size: int = 16,
    dataset_size: int = 128,
    learning_rate: float = 4e-4,
    steps_per_dispatch: int = 25,
    seed: int = 0,
    checkpoint_path: Optional[str] = None,
    *,
    device="cuda",
    init_params=None,
    timing: Optional[dict] = None,
    losses: Optional[list] = None,
    batch_indices=None,
    batch_quads=None,
    batch_noise=None,
):
    """Device-resident training on ``dataset_size`` pages of seed ``seed``.
    ``init_params`` warm-starts from a flax-layout tree; ``timing`` and
    ``losses`` as in ``train_recognizer_device``; ``batch_indices``,
    ``batch_quads`` (each step's (quads [B, 4, 2], bg [B])) and
    ``batch_noise`` ([B, H, W]) replace the step's draws where given (the
    pages' render rate in ``timing["pages_per_s"]``).  Returns (model,
    variables, metrics): the flax-layout tree and :func:`evaluate_boundary`
    on the held-out pages of seed ``seed + 777``."""
    logger = MarieLogger("train-boundary")
    config = config or BoundaryConfig()
    ih, iw = config.input_hw
    model = init_module(config, None, seed, init_params, device)
    dev = next(model.parameters()).device

    logger.info(f"rendering {dataset_size} document pages...")
    t0 = time.perf_counter()
    docs = torch.from_numpy(render_docs(seed, dataset_size, (ih, iw))).to(dev)
    render_s = time.perf_counter() - t0

    schedule = warmup_cosine_decay_schedule(0.0, learning_rate, max(steps // 10, 1), steps)
    norm = torch.tensor([iw - 1.0, ih - 1.0], dtype=torch.float32, device=dev)
    trainer = StepTrainer(model, boundary_loss(model, norm), schedule, weight_decay=1e-4,
                          clip_norm=1.0)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)

    def batch(step):
        idx = draw_indices(gen, dataset_size, batch_size, dev, batch_indices, step)
        return _make_scan(gen, docs[idx], (ih, iw),
                          None if batch_quads is None else batch_quads[step],
                          None if batch_noise is None else batch_noise[step])

    done = 0
    while done < steps:
        n = min(steps_per_dispatch, steps - done)
        with trainer.timed(dev):
            block = [trainer.step(*batch(done + i)) for i in range(n)]
            mean_loss = float(torch.stack(block).mean())
        if losses is not None:
            losses.extend(float(v) for v in block)
        done += n
        if done % 250 == 0 or done == steps:
            logger.info(f"step {done}/{steps} loss={mean_loss:.6f} "
                        f"({trainer.seconds / done:.3f}s/step)")

    model.eval()
    metrics = evaluate_boundary(model, config, seed=seed + 777)
    logger.info(f"eval: {metrics}")
    variables = to_flax(model)
    if checkpoint_path:
        save_params(variables, checkpoint_path)
        logger.info(f"saved to {checkpoint_path}")
    if timing is not None:
        timing.update(trainer.timing(), pages_per_s=dataset_size / render_s)
    return model, variables, metrics


@torch.no_grad()
def evaluate_boundary(model, config, n_pages: int = 64, seed: int = 777, *, quads=None,
                      noise=None):
    """Held-out corner error (px, at the model's resolution) and mean quad
    IoU on ``n_pages`` scans of the seed's pages, on the model's device:
    the JAX figures ``corner_mae_px``, ``corner_p95_px`` and
    ``mean_quad_iou``, rounded as JAX rounds them.  The quads and noise
    come from a ``torch.Generator`` of ``seed`` unless given (``quads`` a
    (quads, bg) pair, as ``_make_scan`` takes them)."""
    ih, iw = config.input_hw
    dev = next(model.parameters()).device
    docs = torch.from_numpy(render_docs(seed, n_pages, (ih, iw))).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    scans, true = _make_scan(gen, docs, (ih, iw), quads, noise)
    norm = torch.tensor([iw - 1.0, ih - 1.0], dtype=torch.float32, device=dev)
    with float32_precision(False):
        pred = model(normalize_page(scans))
    pred_px = pred.reshape(len(scans), 4, 2) * norm
    err = (pred_px - true).abs().cpu().numpy()
    pred_np, true_np = pred_px.cpu().numpy(), true.cpu().numpy()
    ious = [float(quad_iou(p, t, (ih, iw), device=dev)) for p, t in zip(pred_np, true_np)]
    return {
        "corner_mae_px": round(float(err.mean()), 3),
        "corner_p95_px": round(float(np.percentile(err, 95)), 3),
        "mean_quad_iou": round(float(np.mean(np.asarray(ious, np.float32))), 4),
    }
