"""pix2pix overlay-cleanup training (port of ``marie_tpu/train/overlay.py``):
synthetic clean text pages composited with form artifacts (rules, boxes,
shaded regions, stamp ellipses, dotted lines) drawn under the text; the
generator learns to give the text-only page back.  The pix2pix objective:
an LSGAN PatchGAN discriminator and L1 (weight 100).

:func:`render_overlay_pair` equals the JAX renderer to the bit: the same
``np.random.Generator`` calls in the same order, the shapes drawn by
``utils/pil_ops.py``'s copies of Pillow's ``line``, ``rectangle`` and
``ellipse``, the words by the glyph atlas (``utils/glyphs.py``,
DejaVuSans at 14, 18 and 22 px) on the clean page and over the coloured
overlay (each channel blended as Pillow blends it).  PIL's
``load_default()`` fallback has none: a face or size the atlas lacks
raises.

:func:`train_overlay_device` keeps ``dataset_size`` rendered pairs on the
device as uint8 (re-rendered from seed ``seed + 1 + step`` every
``refresh_every`` steps, as JAX does) and draws each step's batch there
from a ``torch.Generator`` (the port cannot repeat ``jax.random``: a test
hands the JAX trainer's draws in as ``draws``).  A step
(:class:`OverlayGan`) is the discriminator's LSGAN step, then the
generator's (GAN + ``l1_weight`` x L1) against the updated discriminator,
each Adam (b1 0.5, b2 0.999, eps 1e-8, ``optax.adam``) in float32 without
TF32.  The JAX step runs the generator forward twice on the same
parameters, once in each loss; the port runs it once and gives the
discriminator's step the output detached (the same numbers, a third less
generator work).  The step's pages map to [-1, 1] as XLA computes ``u8 /
127.5 - 1`` inside a jit (``overlay/overlay.py``'s table).
"""

import time
from typing import Optional, Tuple

import numpy as np
import torch

from marie_tpu_torch.logging_core import MarieLogger
from marie_tpu_torch.models.configs import PatchDiscriminatorConfig, Pix2PixConfig
from marie_tpu_torch.models.pix2pix import PatchDiscriminator  # noqa: F401 (the JAX module's)
from marie_tpu_torch.overlay.overlay import MASK_THRESHOLD, _unit_table
from marie_tpu_torch.registry.checkpoints import save_params
from marie_tpu_torch.registry.convert import build_model, from_flax, to_flax
from marie_tpu_torch.train.loop import init_module
from marie_tpu_torch.train.optim import AdamW
from marie_tpu_torch.train.recognizer import draw_indices
from marie_tpu_torch.utils.device import cudnn_benchmark, float32_precision, on_own_thread
from marie_tpu_torch.utils.glyphs import _blend, load_font
from marie_tpu_torch.utils.pil_ops import draw_ellipse, draw_line, draw_rectangle

_WORDS = (
    "invoice total amount payment due net terms claim policy member "
    "provider service balance statement account number date reference "
    "name address phone code group plan 2024 1500 375.20 11/02/2023"
).split()

_OVERLAY_COLORS = [
    (160, 160, 160), (120, 120, 120), (190, 190, 190),  # form grays
    (90, 110, 200), (70, 130, 90), (200, 120, 110),     # blue/green/red tints
]
FONT_FACE = "DejaVuSans"
FONT_SIZES = (14, 18, 22)
#: the mask of overlay pixels: the pages' largest channel difference above this
MASK_LEVEL = 12
#: pages a generator call of the evaluation
EVAL_CHUNK = 8


def render_overlay_pair(
    rng: np.random.Generator, page_hw: Tuple[int, int] = (512, 384)
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (clean u8 [H,W,3], dirty u8 [H,W,3], overlay_mask u8 [H,W]).

    The overlay layer is drawn first, text second, so a rule crossing a
    word leaves the glyph's pixels intact (the form was printed under the
    text)."""
    h, w = page_hw
    fonts = [load_font(FONT_FACE, s) for s in FONT_SIZES]
    overlay = np.full((h, w, 3), 255, np.uint8)

    def color():
        return _OVERLAY_COLORS[int(rng.integers(0, len(_OVERLAY_COLORS)))]

    # horizontal / vertical rules
    for _ in range(int(rng.integers(2, 8))):
        y = int(rng.integers(0, h))
        draw_line(overlay, [(0, y), (w, y)], color(), int(rng.integers(1, 4)))
    for _ in range(int(rng.integers(0, 4))):
        x = int(rng.integers(0, w))
        draw_line(overlay, [(x, 0), (x, h)], color(), int(rng.integers(1, 3)))

    def ri(lo, hi):
        return int(rng.integers(lo, max(hi, lo + 1)))

    # form boxes
    for _ in range(int(rng.integers(1, 5))):
        x0, y0 = ri(0, w - 60), ri(0, h - 40)
        x1 = min(x0 + ri(50, min(220, max(w - x0, 51))), w - 1)
        y1 = min(y0 + ri(25, min(120, max(h - y0, 26))), h - 1)
        draw_rectangle(overlay, [x0, y0, x1, y1], outline=color(), width=ri(1, 3))
    # shaded regions (light fills)
    for _ in range(int(rng.integers(0, 3))):
        x0, y0 = ri(0, w - 80), ri(0, h - 40)
        x1 = min(x0 + ri(60, min(240, max(w - x0, 61))), w - 1)
        y1 = min(y0 + ri(20, min(90, max(h - y0, 21))), h - 1)
        g = ri(205, 240)
        draw_rectangle(overlay, [x0, y0, x1, y1], fill=(g, g, g))
    # stamp ellipses
    for _ in range(int(rng.integers(0, 3))):
        x0, y0 = ri(0, w - 100), ri(0, h - 60)
        box = [x0, y0, x0 + ri(60, 120), y0 + ri(30, 60)]
        draw_ellipse(overlay, box, outline=color(), width=ri(2, 4))
    # dotted lines
    for _ in range(int(rng.integers(0, 4))):
        y = int(rng.integers(0, h))
        c = color()
        for x in range(0, w, 8):
            draw_line(overlay, [(x, y), (x + 3, y)], c, 1)

    # text on a clean page (black on white: one grey channel) and on top
    # of the overlay layer, one coverage mask for both
    clean = np.full((h, w), 255, np.uint8)
    y = int(rng.integers(10, 40))
    while y < h - 40:
        x = int(rng.integers(10, 40))
        font = fonts[int(rng.integers(0, len(fonts)))]
        while x < w - 80:
            text = str(rng.choice(_WORDS))
            m, (col0, row0) = font.mask(text, (x, y))
            _blend(clean, m, col0, row0, 0)
            _blend(overlay, m, col0, row0, 0)
            x = font.textbbox((x, y), text)[2] + int(rng.integers(10, 40))
        y += int(rng.integers(26, 44))

    clean_rgb = np.repeat(clean[..., None], 3, axis=-1)
    diff = np.abs(clean_rgb.astype(np.int16) - overlay.astype(np.int16)).max(-1)
    return clean_rgb, overlay, (diff > MASK_LEVEL).astype(np.uint8) * 255


def render_block(block_seed: int, n: int, page_hw: Tuple[int, int]):
    """``n`` pairs of seed ``block_seed``: (dirty [n,H,W,3], clean [n,H,W,3])
    uint8."""
    rng = np.random.default_rng(block_seed)
    cleans, dirties = [], []
    for _ in range(n):
        c, d, _ = render_overlay_pair(rng, page_hw)
        cleans.append(c)
        dirties.append(d)
    return np.stack(dirties), np.stack(cleans)


def _constant(lr: float):
    return lambda count: np.float32(lr)


class OverlayGan:
    """One pix2pix step on a generator and a discriminator (trainable
    port modules): :meth:`step` on a batch of dirty pages ``x`` and clean
    ones ``y`` ([B, H, W, 3] in [-1, 1]) steps the discriminator on the
    LSGAN loss ``0.5 * (mean((D(x, y) - 1)^2) + mean(D(x, G(x))^2))``,
    then the generator on ``mean((D'(x, G(x)) - 1)^2) + l1_weight *
    mean(|G(x) - y|)`` with the stepped discriminator D', each by Adam
    (``optax.adam(lr, b1=0.5)``)."""

    def __init__(self, gen, disc, learning_rate: float = 2e-4, l1_weight: float = 100.0):
        self.gen, self.disc = gen, disc
        self.l1_weight = l1_weight
        self.g_params = list(gen.parameters())
        self.d_params = list(disc.parameters())
        adam = dict(b1=0.5, b2=0.999, eps=1e-8, weight_decay=0.0)
        self.g_opt = AdamW(self.g_params, _constant(learning_rate), **adam)
        self.d_opt = AdamW(self.d_params, _constant(learning_rate), **adam)

    def d_loss(self, x, y, fake):
        real_logit = self.disc(torch.cat([x, y], -1))
        fake_logit = self.disc(torch.cat([x, fake], -1))
        return 0.5 * (((real_logit - 1.0) ** 2).mean() + (fake_logit ** 2).mean())

    def g_loss(self, x, y, fake):
        fake_logit = self.disc(torch.cat([x, fake], -1))
        gan = ((fake_logit - 1.0) ** 2).mean()
        l1 = (fake - y).abs().mean()
        return gan + self.l1_weight * l1, l1

    @staticmethod
    def _apply(opt, params, grads):
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()
        opt.zero_grad()

    def step(self, x, y, grads: Optional[dict] = None):
        """One step; returns the detached (d_loss, g_loss, l1).  ``grads``,
        where given, receives each leaf's gradient (``"disc.<name>"``,
        ``"gen.<name>"``)."""
        with float32_precision(False):
            fake = self.gen(x)
            d_loss = self.d_loss(x, y, fake.detach())
            d_grads = torch.autograd.grad(d_loss, self.d_params)
            self._apply(self.d_opt, self.d_params, d_grads)
            g_loss, l1 = self.g_loss(x, y, fake)
            g_grads = torch.autograd.grad(g_loss, self.g_params)
            self._apply(self.g_opt, self.g_params, g_grads)
        if grads is not None:
            for prefix, mod, gs in (("disc", self.disc, d_grads), ("gen", self.gen, g_grads)):
                for (name, _), g in zip(mod.named_parameters(), gs):
                    grads[f"{prefix}.{name}"] = g
        return d_loss.detach(), g_loss.detach(), l1.detach()


def init_overlay(config: Pix2PixConfig, seed: int, init_params=None, device="cuda"):
    """(generator, discriminator), trainable on ``device``: flax-default
    draws of ``seed`` and ``seed + 1`` (JAX's ``PRNGKey(seed)`` and
    ``PRNGKey(seed + 1)``), or the flax-layout trees ``init_params =
    (generator tree, discriminator tree)``."""
    g_tree, d_tree = init_params if init_params is not None else (None, None)
    gen = init_module(config, None, seed, g_tree, device).train()
    disc = init_module(PatchDiscriminatorConfig(), None, seed + 1, d_tree, device).train()
    return gen, disc


def train_overlay_device(
    config: Optional[Pix2PixConfig] = None,
    steps: int = 3000,
    batch_size: int = 4,
    dataset_size: int = 192,
    page_hw: Tuple[int, int] = (512, 384),
    learning_rate: float = 2e-4,
    l1_weight: float = 100.0,
    steps_per_dispatch: int = 25,
    refresh_every: int = 1000,
    seed: int = 0,
    checkpoint_path: Optional[str] = None,
    *,
    device="cuda",
    init_params=None,
    draws=None,
    timing: Optional[dict] = None,
    losses: Optional[list] = None,
):
    """Device-resident pix2pix training on ``dataset_size`` pairs (the JAX
    recipe's defaults).  ``init_params`` = (generator tree, discriminator
    tree) replaces the seeded draws; ``draws[step]`` replaces a step's
    batch indices; ``timing`` receives the steps' timing and the host
    render rate (``pairs_per_s``); ``losses`` each step's (d_loss,
    g_loss, l1).  Returns (generator, its flax-layout tree, metrics):
    :func:`evaluate_overlay` on 32 held-out pages of seed ``seed + 9999``; the tree is written to ``checkpoint_path`` where
    given."""
    logger = MarieLogger("train-overlay")
    config = config or Pix2PixConfig.synth()
    gen, disc = init_overlay(config, seed, init_params, device)
    dev = next(gen.parameters()).device

    def upload(block_seed):
        t = time.perf_counter()
        xs, ys = render_block(block_seed, dataset_size, page_hw)
        seconds = time.perf_counter() - t
        return torch.from_numpy(xs).to(dev), torch.from_numpy(ys).to(dev), seconds

    logger.info(f"rendering {dataset_size} overlay pairs...")
    data_x, data_y, render_s = upload(seed)  # x = dirty, y = clean
    logger.info(f"rendered+uploaded in {render_s:.1f}s")

    gan = OverlayGan(gen, disc, learning_rate, l1_weight)
    unit = _unit_table().to(dev)
    rng = torch.Generator(device=dev).manual_seed(seed + 2)
    state = {"seconds": 0.0, "steps": 0}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def train_steps():
        nonlocal data_x, data_y
        done = 0
        next_refresh = refresh_every
        while done < steps:
            if refresh_every and done >= next_refresh:
                data_x, data_y, _ = upload(seed + 1 + done)
                next_refresh += refresh_every
                logger.info(f"dataset refreshed at step {done}")
            n = min(steps_per_dispatch, steps - done)
            sync()
            t0 = time.perf_counter()
            block = []
            for i in range(n):
                idx = draw_indices(rng, dataset_size, batch_size, dev, draws, done + i)
                block.append(torch.stack(gan.step(unit[data_x[idx].long()],
                                                  unit[data_y[idx].long()])))
            block = torch.stack(block).cpu().double().numpy()  # [n, 3]; synchronises
            state["seconds"] += time.perf_counter() - t0
            state["steps"] += n
            if losses is not None:
                losses.extend(tuple(float(v) for v in row) for row in block)
            done += n
            if done % 250 == 0 or done == steps:
                dl, gl, l1 = block.mean(0)
                logger.info(f"step {done}/{steps} d={dl:.4f} g={gl:.4f} l1={l1:.5f} "
                            f"({state['seconds'] / done:.3f}s/step)")

    if dev.type == "cuda":
        # cuDNN's heuristics' first algorithms took 86.9 ms a step on an H100
        # at 700 W, timing their first three 69.5 (PERF.md §6).  cuDNN keeps each
        # thread's choices: a fresh thread times its own for these shapes
        def timed_steps():
            with cudnn_benchmark():
                train_steps()

        on_own_thread(timed_steps)
    else:
        train_steps()

    gen.eval()
    metrics = evaluate_overlay(gen, None, page_hw, seed=seed + 9999)
    logger.info(f"eval: {metrics}")
    variables = to_flax(gen)
    if checkpoint_path:
        save_params(variables, checkpoint_path)
        logger.info(f"saved generator to {checkpoint_path}")
    if timing is not None:
        seconds, n = state["seconds"], state["steps"]
        timing.update({"steps": n, "train_s": seconds, "ms_per_step": seconds / max(n, 1) * 1e3,
                       "steps_per_s": n / seconds if seconds else 0.0,
                       "pairs_per_s": dataset_size / render_s})
    return gen, variables, metrics


@torch.no_grad()
def evaluate_overlay(gen, g_params=None, page_hw=(512, 384), n_pages: int = 32,
                     seed: int = 123):
    """Held-out overlay removal, as JAX measures it: mask F1 (pixels whose
    channel-mean ``|fake - x|`` exceeds 0.15 against the true overlay
    pixels) and the residual L1 of the cleaned page against the clean one,
    on ``n_pages`` pairs of seed ``seed``.  ``gen`` is the port's
    generator (on its device); ``g_params``, a flax-layout tree, replaces
    its weights in a copy where given.  The generator runs in float32
    without TF32, EVAL_CHUNK pages a call; the figures are computed on the
    host in numpy as JAX computes them."""
    dev = next(gen.parameters()).device
    if g_params is not None:
        gen = from_flax(g_params, build_model(gen.cfg)).to(dev).eval()
    dirties, cleans = render_block(seed, n_pages, page_hw)
    masks = np.abs(cleans.astype(np.int16) - dirties.astype(np.int16)).max(-1) > MASK_LEVEL
    # JAX divides outside its jit here: a division, then the subtraction
    x_np = dirties.astype(np.float32) / np.float32(127.5) - np.float32(1.0)
    fakes = []
    with float32_precision(False):
        for i in range(0, n_pages, EVAL_CHUNK):
            x = torch.from_numpy(x_np[i:i + EVAL_CHUNK]).to(dev)
            fakes.append(gen(x).float().cpu().numpy())
    fake_np = np.concatenate(fakes)

    pred_mask = np.abs(fake_np - x_np).mean(-1) > MASK_THRESHOLD
    tp = float((pred_mask & masks).sum())
    fp = float((pred_mask & ~masks).sum())
    fn = float((~pred_mask & masks).sum())
    precision = tp / max(tp + fp, 1.0)
    recall = tp / max(tp + fn, 1.0)
    f1 = 2 * precision * recall / max(precision + recall, 1e-9)
    clean_ref = cleans.astype(np.float32) / 127.5 - 1.0
    residual_l1 = float(np.abs(fake_np - clean_ref).mean())
    return {
        "mask_precision": round(precision, 4),
        "mask_recall": round(recall, 4),
        "mask_f1": round(f1, 4),
        "residual_l1": round(residual_l1, 5),
    }
