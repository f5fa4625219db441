"""DiT detector training on the CRAFT synthetic page supervision (port of
``marie_tpu/train/dit.py``).

The detector (:class:`~marie_tpu_torch.models.vit.DiTDetector`: a ViT
backbone, a dense upsampling head) trains on the free supervision of
rendered word boxes, its region and affinity targets rendered directly at
the head's stride.  Half of each block is serving-matched: the even pages
render at twice the size (fonts 14-28, targets at twice the stride) and
are downscaled with cv2's ``INTER_AREA`` (``preprocess/resize.py::
resize_area_u8``), as the serving processor hands the model full pages;
the odd pages render natively at small sizes.  The block is rendered on
the host, kept on the device as uint8 and re-rendered from ``seed + 1 +
step`` every ``refresh_every`` steps.  Each step's loss is the weighted
MSE ``mean((1 + 9 t)(out - t)^2)``, stepped by the clip at 1.0 and AdamW
(weight decay 1e-4) on a warmup + cosine schedule, float32 without TF32;
the encoder's attention is K2 and its gradient (``"train"`` path).
"""

import time
from typing import Optional, Tuple

import numpy as np
import torch

from marie_tpu_torch.logging_core import MarieLogger
from marie_tpu_torch.models.configs import ViTConfig
from marie_tpu_torch.preprocess.ops import normalize_page
from marie_tpu_torch.preprocess.resize import resize_area_u8
from marie_tpu_torch.registry.checkpoints import save_params
from marie_tpu_torch.registry.convert import to_flax
from marie_tpu_torch.train.craft import craft_loss, render_page_with_targets
from marie_tpu_torch.train.loop import StepTrainer, init_module
from marie_tpu_torch.train.optim import warmup_cosine_decay_schedule
from marie_tpu_torch.train.recognizer import draw_indices

FONT_SIZES = (7, 9, 11, 13, 18, 22)
FULL_PAGE_FONT_SIZES = (14, 18, 20, 24, 28)


def render_block(block_seed: int, n: int, page_hw: Tuple[int, int], head_stride: int,
                 font_sizes: Tuple[int, ...] = FONT_SIZES,
                 full_page_font_sizes: Tuple[int, ...] = FULL_PAGE_FONT_SIZES):
    """``n`` pages [n, H, W, 3] and targets [n, H/s, W/s, 2] (uint8) of one
    generator: even pages at twice the size, downscaled by ``INTER_AREA``,
    odd pages native."""
    rng = np.random.default_rng(block_seed)
    h, w = page_hw
    pages, targets = [], []
    for i in range(n):
        if i % 2 == 0:
            p2, t = render_page_with_targets(rng, (h * 2, w * 2), font_sizes=full_page_font_sizes,
                                             out_stride=head_stride * 2)
            p = resize_area_u8(p2, (w, h))
        else:
            p, t = render_page_with_targets(rng, page_hw, font_sizes=font_sizes,
                                            out_stride=head_stride)
        pages.append(p)
        targets.append(t)
    return np.stack(pages), np.stack(targets)


def train_dit_device(
    config: Optional[ViTConfig] = None,
    steps: int = 3000,
    batch_size: int = 8,
    dataset_size: int = 256,
    learning_rate: float = 3e-4,
    steps_per_dispatch: int = 25,
    refresh_every: int = 1000,
    seed: int = 0,
    checkpoint_path: Optional[str] = None,
    font_sizes: Tuple[int, ...] = FONT_SIZES,
    full_page_font_sizes: Tuple[int, ...] = FULL_PAGE_FONT_SIZES,
    *,
    device="cuda",
    init_params=None,
    timing: Optional[dict] = None,
    losses: Optional[list] = None,
    batch_indices=None,
):
    """Device-resident training on ``dataset_size`` rendered pages.
    ``init_params`` warm-starts from a flax-layout tree; ``timing``,
    ``losses`` and ``batch_indices`` as in ``train_recognizer_device``
    (the pages' render rate in ``timing["pages_per_s"]``).  Returns
    (model, variables): the flax-layout tree."""
    logger = MarieLogger("train-dit")
    config = config or ViTConfig.dit_synth()
    page_hw: Tuple[int, int] = tuple(config.image_size)
    model = init_module(config, None, seed, init_params, device)
    dev = next(model.parameters()).device
    render_s = 0.0

    def upload(block_seed):
        nonlocal render_s
        t0 = time.perf_counter()
        pages, targets = render_block(block_seed, dataset_size, page_hw, config.head_stride,
                                      font_sizes, full_page_font_sizes)
        render_s += time.perf_counter() - t0
        return torch.from_numpy(pages).to(dev), torch.from_numpy(targets).to(dev)

    logger.info(f"rendering {dataset_size} training pages at {page_hw}...")
    t0 = time.time()
    data_pages, data_targets = upload(seed)
    logger.info(f"rendered+uploaded in {time.time() - t0:.1f}s")
    rendered = dataset_size

    warmup = max(steps // 10, 1)
    schedule = warmup_cosine_decay_schedule(0.0, learning_rate, warmup, steps)
    trainer = StepTrainer(model, craft_loss(model), schedule, weight_decay=1e-4, clip_norm=1.0)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)

    def batch(step):
        idx = draw_indices(gen, dataset_size, batch_size, dev, batch_indices, step)
        # the targets are already at the head's grid
        return normalize_page(data_pages[idx]), normalize_page(data_targets[idx])

    done = 0
    next_refresh = refresh_every
    while done < steps:
        if refresh_every and done >= next_refresh:
            data_pages, data_targets = upload(seed + 1 + done)
            rendered += dataset_size
            next_refresh += refresh_every
            logger.info(f"dataset refreshed at step {done}")
        n = min(steps_per_dispatch, steps - done)
        with trainer.timed(dev):
            block = [trainer.step(*batch(done + i)) for i in range(n)]
            mean_loss = float(torch.stack(block).mean())
        if losses is not None:
            losses.extend(float(v) for v in block)
        done += n
        if done % 250 == 0 or done == steps:
            logger.info(f"step {done}/{steps} loss={mean_loss:.5f} "
                        f"({trainer.seconds / done:.3f}s/step)")

    model.eval()
    variables = to_flax(model)
    if checkpoint_path:
        save_params(variables, checkpoint_path)
        logger.info(f"saved checkpoint to {checkpoint_path}")
    if timing is not None:
        timing.update(trainer.timing(), pages_per_s=rendered / render_s)
    return model, variables
