"""CTC training of the CRNN recognizer, the voting engine's second reader
(port of ``marie_tpu/train/crnn.py``).

The recipe is the recognizer's: synthetic crops (``SyntheticWordDataset``
at the CRNN's 32-pixel height, grey), rendered a block at a time on the
host and kept on the device as uint8, ``batch_size`` drawn a step with
their noise on the device.  The loss is ``optax.ctc_loss(..., blank_id=0)
.mean()`` (:func:`ctc_loss`).

As in the JAX trainer the model runs with ``train=False``: BatchNorm
normalises with its running statistics, and those are leaves of the
optimised variables (``train/batchnorm.py::train_running_statistics``),
stepped by the clip and AdamW like the parameters.  The LSTMs' input
biases (``bias_ih``, zero: flax's cells have none) stay out of the
optimiser.
"""

import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from marie_tpu_torch.logging_core import MarieLogger
from marie_tpu_torch.models.configs import CRNNConfig, DecoderConfig, TrOCRConfig, ViTConfig
from marie_tpu_torch.models.tokenizer import CTCCharTokenizer
from marie_tpu_torch.ops.ctc import ctc_greedy_decode
from marie_tpu_torch.registry.checkpoints import save_params
from marie_tpu_torch.registry.convert import to_flax
from marie_tpu_torch.train import batchnorm
from marie_tpu_torch.train.loop import StepTrainer, init_module
from marie_tpu_torch.train.optim import warmup_cosine_decay_schedule
from marie_tpu_torch.train.recognizer import (
    SyntheticWordDataset,
    add_noise,
    character_error_rate,
    draw_indices,
)
from marie_tpu_torch.utils.device import cudnn_benchmark, float32_precision, on_own_thread

MAX_LABEL = 24
#: optax's stand-in for log(0)
LOG_EPSILON = -1e5


def _crnn_render_config(width: int, height: int) -> TrOCRConfig:
    """Reuse SyntheticWordDataset via a crop-geometry carrier config."""
    return TrOCRConfig(
        encoder=ViTConfig(image_size=(height, width), use_cls_token=False),
        decoder=DecoderConfig(max_len=32),
    )


def alignments_possible(labels: np.ndarray, lengths: np.ndarray, frames: int) -> bool:
    """Whether every row's label can be aligned to ``frames`` CTC frames:
    its length plus a blank between each repeated pair."""
    for lab, n in zip(labels, lengths):
        lab = lab[:n]
        if n + int((lab[1:] == lab[:-1]).sum()) > frames:
            return False
    return True


def _optax_ctc(logprobs: torch.Tensor, labels: torch.Tensor, lengths: torch.Tensor):
    """optax's ``ctc_loss_with_forward_probs`` recursion (no logit padding):
    the per-row loss [B] with ``log_epsilon`` standing in for log(0), so
    an alignment that cannot be made gives a large finite loss."""
    b, t, _ = logprobs.shape
    n = labels.shape[1]
    dev = logprobs.device
    eps = LOG_EPSILON
    repeat = F.pad((labels[:, :-1] == labels[:, 1:]).to(torch.float32), (0, 1))
    phi_t = logprobs[:, :, 0].transpose(0, 1)[:, :, None]  # [T, B, 1]
    emit_t = torch.gather(logprobs, 2, labels.long()[:, None, :].expand(b, t, n)).transpose(0, 1)
    phi = torch.full((b, n + 1), eps, device=dev)
    phi = torch.cat([torch.zeros((b, 1), device=dev), phi[:, 1:]], dim=1)
    emit = torch.full((b, n), eps, device=dev)

    def add_phi(p, score):
        return torch.cat([p[:, :1], torch.logaddexp(p[:, 1:], score)], dim=1)

    for step in range(t):
        prev_phi = add_phi(phi, emit + eps * repeat)
        le, lp = emit_t[step], phi_t[step]
        next_emit = torch.logaddexp(prev_phi[:, :-1] + le, emit + le)
        next_phi = add_phi(prev_phi + lp, emit + lp + eps * (1.0 - repeat))
        phi, emit = next_phi, next_emit
    last = add_phi(phi, emit)
    return -torch.gather(last, 1, lengths.long()[:, None])[:, 0]


def ctc_loss(logits: torch.Tensor, labels: torch.Tensor, lengths: torch.Tensor,
             possible: bool = True) -> torch.Tensor:
    """``optax.ctc_loss(logits, 0, labels, label_paddings, blank_id=0)``
    per row [B]: logits [B, T, V], labels [B, N] (zero past each
    ``lengths``).  Where every alignment can be made (``possible``; see
    :func:`alignments_possible`) this is ``F.ctc_loss(reduction="none")``,
    which agrees with optax there; otherwise optax's own recursion, whose
    ``log_epsilon`` gives a large finite loss where torch gives inf."""
    logprobs = torch.log_softmax(logits.to(torch.float32), dim=-1)
    if not possible:
        return _optax_ctc(logprobs, labels, lengths)
    b, t, _ = logits.shape
    frames = torch.full((b,), t, dtype=torch.long, device=logits.device)
    return F.ctc_loss(logprobs.transpose(0, 1), labels.long(), frames, lengths.long(), blank=0,
                      reduction="none", zero_infinity=False)


@torch.no_grad()
def crnn_cer(model, images: np.ndarray, texts, tokenizer: CTCCharTokenizer) -> float:
    """Mean CER of the greedy CTC decode of ``images`` [N, 32, W, 3] (grey:
    the channel mean, as the JAX function reads the crops) against
    ``texts``, float32 without TF32."""
    gray = images.mean(axis=-1, keepdims=True)
    p = next(model.parameters())
    with float32_precision(False):
        logits = model(torch.from_numpy(gray).to(p.device, p.dtype))
    tokens, lengths, _ = ctc_greedy_decode(logits, blank_id=0)
    tokens, lengths = tokens.cpu().numpy(), lengths.cpu().numpy()
    cers = [character_error_rate(tokenizer.decode(tokens[i, : lengths[i]]), texts[i])
            for i in range(len(texts))]
    return float(np.mean(cers))


def evaluate_crnn_cer(model, dataset: SyntheticWordDataset, tokenizer: CTCCharTokenizer,
                      n_samples: int = 64) -> float:
    """Mean CER of the greedy CTC decode over ``dataset.sample(n_samples)``
    (:func:`crnn_cer`)."""
    images, _, texts = dataset.sample(n_samples)
    return crnn_cer(model, images, texts, tokenizer)


def render_crnn_block(render_cfg: TrOCRConfig, tokenizer: CTCCharTokenizer, block_seed: int,
                      dataset_size: int):
    """(grey uint8 [N, 32, W, 1], labels [N, 24] int32, lengths [N] int32),
    512 crops at a time as the JAX ``render_block`` draws them."""
    ds = SyntheticWordDataset(render_cfg, seed=block_seed, noise=0.0)
    imgs_l, labs_l, lens_l = [], [], []
    for start in range(0, dataset_size, 512):
        n = min(512, dataset_size - start)
        images, _, texts = ds.sample(n)
        gray = (images.mean(axis=-1, keepdims=True) * 255).astype(np.uint8)
        labels = np.zeros((n, MAX_LABEL), np.int32)
        lengths = np.zeros((n,), np.int32)
        for i, t in enumerate(texts):
            ids = tokenizer.encode(t)[:MAX_LABEL]
            labels[i, : len(ids)] = ids
            lengths[i] = len(ids)
        imgs_l.append(gray)
        labs_l.append(labels)
        lens_l.append(lengths)
    return np.concatenate(imgs_l), np.concatenate(labs_l), np.concatenate(lens_l)


def crnn_trainable(model) -> list:
    """The tensors the JAX trainer's optimiser steps: the parameters but
    the LSTMs' zero input biases, and the BatchNorm running statistics
    (which this makes leaves that require a gradient)."""
    params = []
    for name, p in model.named_parameters():
        if ".bias_ih_" in name:
            p.requires_grad_(False)
        else:
            params.append(p)
    return params + batchnorm.train_running_statistics(model)


def crnn_loss(model, possible: bool = True):
    """The step's loss: ``loss_fn(images, labels, lengths)``."""

    def loss_fn(images, labels, lengths):
        return ctc_loss(model(images), labels, lengths, possible).mean()

    return loss_fn


def train_crnn_device(
    config: Optional[CRNNConfig] = None,
    steps: int = 8000,
    batch_size: int = 128,
    dataset_size: int = 8192,
    width: int = 256,
    learning_rate: float = 1e-3,
    steps_per_dispatch: int = 50,
    refresh_every: int = 2000,
    noise: float = 0.03,
    seed: int = 0,
    checkpoint_path: Optional[str] = None,
    *,
    device="cuda",
    init_params=None,
    timing: Optional[dict] = None,
    eval_samples: int = 64,
    losses: Optional[list] = None,
    batch_indices=None,
    batch_noise=None,
):
    """Device-resident CTC training (the JAX trainer's schedule: warmup +
    cosine, clip 1.0, AdamW with weight decay 1e-4; blocks re-rendered
    with seed ``seed + 1 + step`` every ``refresh_every`` steps).
    ``init_params`` warm-starts from a flax-layout tree.  Returns (model,
    variables, cer): the flax-layout tree (params and batch_stats) and the
    CER on ``eval_samples`` crops of the seed-``seed`` dataset, as JAX
    measures it.  ``timing``, ``losses``, ``batch_indices`` and
    ``batch_noise`` as in ``train_recognizer_device``."""
    logger = MarieLogger("train-crnn")
    config = config or CRNNConfig()
    tokenizer = CTCCharTokenizer()
    assert config.num_classes >= tokenizer.vocab_size
    h = config.input_height
    render_cfg = _crnn_render_config(width, h)
    dataset = SyntheticWordDataset(render_cfg, seed=seed, noise=0.0)
    frames = width // 4

    model = init_module(config, None, seed, init_params, device).train()
    dev = next(model.parameters()).device

    def upload(block_seed):
        imgs, labs, lens = render_crnn_block(render_cfg, tokenizer, block_seed, dataset_size)
        return ([torch.from_numpy(a).to(dev) for a in (imgs, labs, lens)],
                alignments_possible(labs, lens, frames))

    logger.info(f"rendering {dataset_size} CRNN crops...")
    t0 = time.time()
    (data_imgs, data_labs, data_lens), possible = upload(seed)
    logger.info(f"rendered+uploaded in {time.time() - t0:.1f}s")

    warmup = max(steps // 10, 1)
    schedule = warmup_cosine_decay_schedule(0.0, learning_rate, warmup, steps)
    params = crnn_trainable(model)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)

    def batch(step):
        idx = draw_indices(gen, dataset_size, batch_size, dev, batch_indices, step)
        images = data_imgs[idx].to(torch.float32) / 255.0
        if noise > 0:
            images = add_noise(images, noise, gen, batch_noise, step)
        return images, data_labs[idx], data_lens[idx]

    trainer = StepTrainer(model, crnn_loss(model, possible), schedule, weight_decay=1e-4,
                          clip_norm=1.0, params=params)

    def train_steps():
        nonlocal data_imgs, data_labs, data_lens
        done = 0
        next_refresh = refresh_every
        with cudnn_benchmark():
            while done < steps:
                if refresh_every and done >= next_refresh:
                    (data_imgs, data_labs, data_lens), possible = upload(seed + 1 + done)
                    trainer.loss_fn = crnn_loss(model, possible)
                    next_refresh += refresh_every
                    logger.info(f"dataset refreshed at step {done}")
                n = min(steps_per_dispatch, steps - done)
                with trainer.timed(dev):
                    block = [trainer.step(*batch(done + i)) for i in range(n)]
                    mean_loss = float(torch.stack(block).mean())
                if losses is not None:
                    losses.extend(float(v) for v in block)
                done += n
                if done % 500 == 0 or done == steps:
                    logger.info(f"step {done}/{steps} loss={mean_loss:.4f} "
                                f"({trainer.seconds / done:.3f}s/step)")

    try:
        # cuDNN's heuristics pick FFT convolutions for the float32 ResNet
        # at batch 128: a step took 131.8 ms on an H100, 47.1 ms with
        # their first three candidates timed, once, in 2.6 s
        # (scripts/profile_train_step.py --model crnn).  cuDNN keeps each
        # thread's choices: a fresh thread times its own, even where this
        # one ran the CRNN at this shape before (a serving engine)
        on_own_thread(train_steps)
    finally:
        batchnorm.restore(model)
    model.eval()
    cer = evaluate_crnn_cer(model, dataset, tokenizer, n_samples=eval_samples)
    logger.info(f"final CER={cer:.4f} after {steps} steps")
    variables = to_flax(model)
    if checkpoint_path:
        save_params(variables, checkpoint_path)
        logger.info(f"saved checkpoint to {checkpoint_path}")
    if timing is not None:
        timing.update(trainer.timing())
    return model, variables, cer
