"""Recognizer training on synthetic word crops (port of
``marie_tpu/train/recognizer.py``).

:class:`SyntheticWordDataset` renders random words, amounts, dates and
codes as the serving crops look: a tight ink box, random margins, an
aspect-preserving resize to the crop height and white right padding, with
the JAX package's augmentations (baseline tilt, low resolution, synthetic
bold by stroke and stem dilation, shear, ordered dither, noise).  It draws
with the glyph atlas (:mod:`marie_tpu_torch.utils.glyphs`) and PIL's image
operations in numpy (:mod:`marie_tpu_torch.utils.pil_ops`) instead of PIL:
it makes the same ``numpy.random.Generator`` calls in the same order as
the JAX dataset, over the same font list (faces, then sizes), so a seed
gives the same texts, tokens and augmentation draws, and the images PIL's
renders give.

:func:`train_recognizer_device` keeps a rendered block on the device as
uint8 and draws each step's batch and noise there from a
``torch.Generator`` (JAX draws them from ``jax.random``); the next block
renders on a prefetch thread.  Each step is the teacher-forced TrOCR
forward (K2 in every encoder layer and in every causal decoder
self-attention, and K2's gradient kernel for both, on the card), the
masked cross entropy, optax's global-norm clip at 1.0 and AdamW on a
warmup + cosine schedule, float32 without TF32.  :func:`evaluate_cer`
reads held-out crops with the greedy decode.
"""

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from marie_tpu_torch.logging_core import MarieLogger
from marie_tpu_torch.models.configs import TrOCRConfig
from marie_tpu_torch.models.tokenizer import CharTokenizer
from marie_tpu_torch.models.trocr import greedy_decode
from marie_tpu_torch.ops.kernels._build import launch_path
from marie_tpu_torch.registry.checkpoints import save_params
from marie_tpu_torch.registry.convert import to_flax
from marie_tpu_torch.train.loop import StepTrainer, init_module
from marie_tpu_torch.train.optim import warmup_cosine_decay_schedule
from marie_tpu_torch.utils import pil_ops
from marie_tpu_torch.utils.glyphs import load_font
from marie_tpu_torch.utils.pack4 import _BAYER8_T

_WORDS = (
    "invoice total amount payment due net terms claim policy member "
    "provider service balance statement account number date reference "
    "the and for with from name address city state zip phone email "
    "description quantity price tax subtotal discount paid remit code "
    "group plan benefit patient doctor hospital pharmacy charge copay"
).split()

# open-vocabulary generators (text_mode="open"): random n-grams force
# char-level reading; syllable pseudo-words cover natural glyph statistics
# without teaching a lexicon; codes, currency and punctuation match what
# detector crops contain on real documents
_SYLLABLES = (
    "ba be bi bo bu ca ce ci co cu da de di do du fa fe fi fo fu "
    "ga ge gi go gu ha he hi ho hu ja jo ka ke ki ko la le li lo lu "
    "ma me mi mo mu na ne ni no nu pa pe pi po pu ra re ri ro ru "
    "sa se si so su ta te ti to tu va ve vi vo wa we wi wo "
    "tion ment ing ness able ster tran pre per pro con com ex "
    "ch sh th st tr pl br gr str nd rt ly er ed es al ar or an en in on"
).split()
_PUNCT_PREFIX = ["(", "[", '"', "'", ""]
_PUNCT_SUFFIX = [",", ".", ";", ":", "!", "?", ")", "]", '"', "'", "%", ""]

#: ink threshold of the tight boxes (grey < 160)
_INK = 160


def _ink_box(gray: np.ndarray):
    ys, xs = np.nonzero(gray < _INK)
    if not len(ys):
        return None
    return int(xs.min()), int(ys.min()), int(xs.max()) + 1, int(ys.max()) + 1


class SyntheticWordDataset:
    """Renders random words/amounts/dates as crop images.

    Yields (images [B,H,W,3] float32 0..1, tokens [B,L] int32, texts)
    batches; tokens are BOS-prefixed, EOS-terminated, PAD-filled (the
    teacher-forcing layout of the train step)."""

    #: the trained faces, in the JAX dataset's font-file order;
    #: DejaVuSerif-Bold stays held out (the oracle's unseen face)
    FONT_FACES = ("DejaVuSans", "DejaVuSans-Bold", "DejaVuSansMono", "DejaVuSansMono-Bold",
                  "DejaVuSerif")

    def __init__(
        self,
        config: TrOCRConfig,
        tokenizer: Optional[CharTokenizer] = None,
        seed: int = 0,
        font_sizes: Tuple[int, ...] = (18, 24, 30),
        noise: float = 0.03,
        rotate_deg: float = 0.0,
        rotate_p: float = 0.35,
        lowres_p: float = 0.25,
        text_mode: str = "lexicon",
        bold_p: float = 0.0,
        shear_p: float = 0.0,
        dither_p: float = 0.0,
    ):
        self.cfg = config
        self.text_mode = text_mode
        self.tokenizer = tokenizer or CharTokenizer()
        self.rng = np.random.default_rng(seed)
        self.h, self.w = config.encoder.image_size
        self.max_len = config.decoder.max_len
        self.font_sizes = font_sizes
        self.noise = noise
        self.rotate_deg = rotate_deg
        self.rotate_p = rotate_p
        self.lowres_p = lowres_p
        self.bold_p = bold_p
        self.shear_p = shear_p
        self.dither_p = dither_p
        # every face at every size, or a raise: the atlas has no stand-in
        self._fonts = [load_font(face, size) for face in self.FONT_FACES for size in font_sizes]

    def _random_text(self) -> str:
        if self.text_mode == "open":
            return self._random_text_open()
        kind = self.rng.integers(0, 4)
        if kind == 0:  # word
            return str(self.rng.choice(_WORDS))
        if kind == 1:  # number / amount
            v = self.rng.integers(0, 1_000_000)
            return f"{v / 100:.2f}" if self.rng.random() < 0.5 else str(v)
        if kind == 2:  # date
            return (
                f"{self.rng.integers(1, 13):02d}/"
                f"{self.rng.integers(1, 29):02d}/"
                f"{self.rng.integers(1990, 2030)}"
            )
        # mixed-case / upper word
        wd = str(self.rng.choice(_WORDS))
        return wd.upper() if self.rng.random() < 0.5 else wd.capitalize()

    def _case(self, wd: str) -> str:
        r = self.rng.random()
        if r < 0.60:
            return wd
        if r < 0.80:
            return wd.capitalize()
        return wd.upper()

    def _random_text_open(self) -> str:
        rng = self.rng
        r = rng.random()
        if r < 0.18:  # random letter n-gram
            n = int(rng.integers(1, 13))
            core = "".join(chr(97 + int(c)) for c in rng.integers(0, 26, n))
            text = self._case(core)
        elif r < 0.34:  # pronounceable pseudo-word (2-5 syllables)
            n = int(rng.integers(1, 5))
            core = "".join(str(rng.choice(_SYLLABLES)) for _ in range(n + 1))[:14]
            text = self._case(core)
        elif r < 0.54:  # domain word
            text = self._case(str(rng.choice(_WORDS)))
        elif r < 0.66:  # alphanumeric code: AB-1234, X9/Z07, 12_345
            seps = "-/._"
            parts = []
            for _ in range(int(rng.integers(1, 3)) + 1):
                k = int(rng.integers(1, 5))
                alpha = rng.random() < 0.5
                parts.append("".join(
                    chr((65 if alpha else 48) + int(c))
                    for c in rng.integers(0, 26 if alpha else 10, k)))
            text = str(rng.choice(list(seps))).join(parts)[:14]
        elif r < 0.78:  # number / amount / currency / percent
            v = int(rng.integers(0, 10_000_000))
            rr = rng.random()
            if rr < 0.3:
                text = f"${v / 100:,.2f}"
            elif rr < 0.45:
                text = f"{int(rng.integers(0, 1000)) / 10:.1f}%"
            elif rr < 0.7:
                text = f"{v / 100:.2f}"
            else:
                text = str(v)
        elif r < 0.84:  # date
            text = (
                f"{rng.integers(1, 13):02d}/"
                f"{rng.integers(1, 29):02d}/"
                f"{rng.integers(1990, 2030)}"
            )
        else:  # punctuation-attached token
            base = (
                str(rng.choice(_WORDS))
                if rng.random() < 0.5
                else "".join(chr(97 + int(c))
                             for c in rng.integers(0, 26, int(rng.integers(2, 9))))
            )
            text = (str(rng.choice(_PUNCT_PREFIX)) + self._case(base)
                    + str(rng.choice(_PUNCT_SUFFIX)))
        return text[:14] if len(text) > 14 else text

    def render_gray(self, text: str) -> np.ndarray:
        """The crop of ``text`` as uint8 [H, W] grey, before the noise: the
        JAX ``render``'s image (its three channels are this one)."""
        font = self._fonts[int(self.rng.integers(0, len(self._fonts)))]
        canvas = np.full((2 * self.h, 4 * self.w), 255, np.uint8)
        x0, y0 = 20, 20
        stroke = 0
        dilate = 0
        if self.bold_p > 0 and self.rng.random() < self.bold_p:
            r = self.rng.random()
            if r < 0.40:
                # uniform outline stroke
                stroke = 1 if font.size < 24 or self.rng.random() < 0.5 else 2
            elif r < 0.80:
                # anisotropic ink dilation (vertical stems)
                dilate = 1 if font.size < 24 or self.rng.random() < 0.5 else 2
            else:
                # heavy bold: stroke and stem dilation together
                stroke = 1
                dilate = 1
        if stroke or dilate:
            # char by char with +1..2 px spacing, as real bold cuts widen
            # the advance
            extra = 1 if font.size < 24 else 2
            cx = float(x0)
            for ch in text:
                font.draw_text(canvas, (cx, y0), ch, fill=0, stroke_width=stroke)
                cx += font.textlength(ch) + extra
            bbox = _ink_box(canvas) or font.textbbox((x0, y0), text, stroke_width=stroke)
        else:
            font.draw_text(canvas, (x0, y0), text, fill=0)
            bbox = font.textbbox((x0, y0), text)
        if dilate:
            g = canvas
            out = g
            for k in range(1, dilate + 1):
                # ink is dark: min over horizontal shifts == stem dilation
                out = np.minimum(out, np.pad(g[:, k:], ((0, 0), (0, k)), constant_values=255))
            if self.rng.random() < 0.35:
                # slight vertical component too
                out = np.minimum(out, np.pad(g[1:, :], ((0, 1), (0, 0)), constant_values=255))
            canvas = out
            bbox = (bbox[0], bbox[1], bbox[2] + dilate, bbox[3])
        ch_, cw_ = canvas.shape
        if self.shear_p > 0 and self.rng.random() < self.shear_p:
            # synthetic italic: horizontal shear about the baseline
            sh = float(self.rng.uniform(-0.25, 0.25))
            canvas = pil_ops.transform_affine(canvas, (cw_, ch_), (1, sh, -sh * y0, 0, 1, 0), 255)
            bbox = _ink_box(canvas) or bbox
        if self.rotate_deg > 0 and self.rng.random() < self.rotate_p:
            angle = float(self.rng.uniform(-self.rotate_deg, self.rotate_deg))
            cx, cy = (bbox[0] + bbox[2]) / 2.0, (bbox[1] + bbox[3]) / 2.0
            canvas = pil_ops.rotate(canvas, angle, (cx, cy), 255)
            # the detector boxes a rotated word by its axis-aligned ink extent
            bbox = _ink_box(canvas) or bbox
        # random asymmetric margins like real detector boxes
        ml, mt, mr, mb = (int(self.rng.integers(0, 7)) for _ in range(4))
        tight = pil_ops.crop(canvas, (bbox[0] - ml, bbox[1] - mt, bbox[2] + mr, bbox[3] + mb))
        if self.lowres_p > 0 and self.rng.random() < self.lowres_p:
            f = float(self.rng.uniform(0.4, 0.7))
            th0, tw0 = tight.shape
            small = pil_ops.resize_bilinear(tight, (max(1, int(tw0 * f)), max(1, int(th0 * f))))
            tight = pil_ops.resize_bilinear(small, (tw0, th0))
        if self.dither_p > 0 and self.rng.random() < self.dither_p:
            gh, gw = tight.shape
            oy = int(self.rng.integers(0, 8))
            ox = int(self.rng.integers(0, 8))
            thresh = np.tile(np.roll(_BAYER8_T, (oy, ox), axis=(0, 1)),
                             ((gh + 7) // 8, (gw + 7) // 8))[:gh, :gw]
            tight = (tight > thresh).astype(np.uint8) * 255
        th, tw = tight.shape
        scale = self.h / max(th, 1)
        new_w = max(1, min(int(round(tw * scale)), self.w))
        img = np.full((self.h, self.w), 255, np.uint8)
        img[:, :new_w] = pil_ops.resize_bilinear(tight, (new_w, self.h))
        return img

    def render(self, text: str) -> np.ndarray:
        """The crop of ``text`` as [H, W, 3] float32 in [0, 1], noise added."""
        gray = self.render_gray(text)
        arr = np.repeat(gray[:, :, None], 3, axis=2).astype(np.float32) / 255.0
        if self.noise > 0:
            arr = arr + self.rng.normal(0, self.noise, arr.shape).astype(np.float32)
        return np.clip(arr, 0.0, 1.0)

    def sample(self, batch_size: int) -> Tuple[np.ndarray, np.ndarray, List[str]]:
        texts = [self._random_text() for _ in range(batch_size)]
        images = np.stack([self.render(t) for t in texts])
        tokens = np.full((batch_size, self.max_len), self.tokenizer.pad_id, np.int32)
        for i, t in enumerate(texts):
            ids = [self.tokenizer.bos_id] + self.tokenizer.encode(t, add_eos=True)
            ids = ids[: self.max_len]
            tokens[i, : len(ids)] = ids
        return images, tokens, texts

    def batches(self, batch_size: int, steps: int) -> Iterator:
        for _ in range(steps):
            yield self.sample(batch_size)


def character_error_rate(pred: str, truth: str) -> float:
    """Levenshtein distance / len(truth)."""
    m, n = len(pred), len(truth)
    if n == 0:
        return float(m > 0)
    prev = list(range(n + 1))
    for i in range(1, m + 1):
        cur = [i] + [0] * n
        for j in range(1, n + 1):
            cur[j] = min(
                prev[j] + 1,
                cur[j - 1] + 1,
                prev[j - 1] + (pred[i - 1] != truth[j - 1]),
            )
        prev = cur
    return prev[n] / n


def decode_cer(model, images: np.ndarray, texts: List[str], tokenizer: CharTokenizer,
               batch_size: int = 512) -> float:
    """Mean CER of the greedy decode of ``images`` [N, H, W, 3] against
    ``texts``: ``batch_size`` crops at a time on the module's device, in
    its dtype, K2 counted on the ``"train"`` path."""
    p = next(model.parameters())
    toks = []
    for s in range(0, len(images), batch_size):
        x = torch.from_numpy(images[s:s + batch_size]).to(p.device, p.dtype)
        with launch_path("train"):
            toks.append(greedy_decode(model, x)[0].cpu().numpy())
    toks = np.concatenate(toks)
    cers = [character_error_rate(tokenizer.decode(toks[i]), texts[i]) for i in range(len(texts))]
    return float(np.mean(cers))


def evaluate_cer(model, dataset: SyntheticWordDataset, tokenizer: CharTokenizer,
                 n_samples: int = 64) -> float:
    """Mean CER of the greedy decode over ``dataset.sample(n_samples)``
    (the JAX function's, the module holding its own weights; see
    :func:`decode_cer`)."""
    images, _, texts = dataset.sample(n_samples)
    return decode_cer(model, images, texts, tokenizer)


def render_block(config: TrOCRConfig, tokenizer: CharTokenizer, block_seed: int,
                 dataset_size: int, **dataset_kwargs) -> Tuple[np.ndarray, np.ndarray]:
    """One host-rendered dataset block: (images uint8 [N, H, W, 3], tokens
    [N, L] int32), the crops drawn 512 at a time without noise as the JAX
    trainer's ``render_block_np`` draws them (numpy only: safe on a
    prefetch thread)."""
    ds = SyntheticWordDataset(config, tokenizer, seed=block_seed, noise=0.0, **dataset_kwargs)
    imgs_l, toks_l = [], []
    for start in range(0, dataset_size, 512):
        n = min(512, dataset_size - start)
        images, tokens, _ = ds.sample(n)
        imgs_l.append((images * 255).astype(np.uint8))
        toks_l.append(tokens)
    return np.concatenate(imgs_l), np.concatenate(toks_l)


def draw_indices(gen, dataset_size: int, batch_size: int, dev, given, step: int):
    """A step's batch indices: ``given[step]`` where a test gives them,
    else drawn on the device."""
    if given is not None:
        return torch.as_tensor(np.asarray(given[step]), dtype=torch.long, device=dev)
    return torch.randint(0, dataset_size, (batch_size,), generator=gen, device=dev)


def add_noise(images: torch.Tensor, scale, gen, given, step: int) -> torch.Tensor:
    """``clip(images + scale * normal, 0, 1)`` (``scale`` a number or a
    per-image tensor), or ``given[step]`` added where a test gives it."""
    if given is not None:
        noise = torch.as_tensor(np.asarray(given[step]), device=images.device)
    else:
        noise = scale * torch.randn(images.shape, generator=gen, device=images.device)
    return torch.clamp(images + noise, 0.0, 1.0)


def recognizer_loss(model, pad_id: int):
    """The teacher-forced step's loss: ``loss_fn(images, tokens)``."""
    # imported here: parallel/train.py imports train/optim.py, which runs
    # this package's __init__
    from marie_tpu_torch.parallel.train import cross_entropy_loss

    def loss_fn(images, tokens):
        logits = model(images, tokens[:, :-1])
        return cross_entropy_loss(logits, tokens[:, 1:], pad_id)

    return loss_fn


def train_recognizer_device(
    config: Optional[TrOCRConfig] = None,
    steps: int = 3000,
    batch_size: int = 128,
    dataset_size: int = 8192,
    learning_rate: float = 3e-4,
    steps_per_dispatch: int = 50,
    noise: float = 0.03,
    rotate_deg: float = 0.0,
    seed: int = 0,
    checkpoint_path: Optional[str] = None,
    eval_samples: int = 128,
    refresh_every: int = 2000,
    text_mode: str = "lexicon",
    font_sizes: Tuple[int, ...] = (18, 24, 30),
    bold_p: float = 0.0,
    shear_p: float = 0.0,
    dither_p: float = 0.0,
    init_params=None,
    *,
    device="cuda",
    timing: Optional[dict] = None,
    losses: Optional[list] = None,
    batch_indices=None,
    batch_noise=None,
):
    """Device-resident training: a block of ``dataset_size`` crops is
    rendered on the host and uploaded once as uint8; each step draws
    ``batch_size`` of them and their noise on the device.  A fresh block
    (seed ``seed + 1 + k * refresh_every``) renders on a prefetch thread
    and replaces the current one every ``refresh_every`` steps.  The loss
    is read back once each ``steps_per_dispatch`` steps.  ``init_params``
    (a flax-layout tree, e.g. a ``torch_zoo/`` tree) warm-starts the
    module; otherwise it starts from ``init_flax_defaults(config,
    seed)``.  ``timing``, a dict, receives the steps' timing, and
    ``losses``, a list, each step's loss.  ``batch_indices`` and
    ``batch_noise`` (per step: the crops' indices, and the noise added to
    them) replace the device's draws, so that a test can feed the JAX
    trainer's ``jax.random`` batches.  Returns (model, params, cer): the
    flax-layout tree and the CER on clean held-out crops (seed ``seed +
    9999``)."""
    logger = MarieLogger("train-recognizer")
    config = config or TrOCRConfig.fast()
    tokenizer = CharTokenizer()
    assert config.decoder.vocab_size >= tokenizer.vocab_size
    ds_kwargs = dict(rotate_deg=rotate_deg, text_mode=text_mode, font_sizes=font_sizes,
                     bold_p=bold_p, shear_p=shear_p, dither_p=dither_p)

    logger.info(f"rendering {dataset_size} synthetic crops...")
    t0 = time.time()
    imgs_np, toks_np = render_block(config, tokenizer, seed, dataset_size, **ds_kwargs)
    model = init_module(config, None, seed, init_params, device).train()
    dev = next(model.parameters()).device
    data_imgs, data_toks = torch.from_numpy(imgs_np).to(dev), torch.from_numpy(toks_np).to(dev)
    logger.info(f"dataset rendered+uploaded in {time.time() - t0:.1f}s")

    warmup = max(steps // 10, 1)
    schedule = warmup_cosine_decay_schedule(0.0, learning_rate, warmup, steps)
    trainer = StepTrainer(model, recognizer_loss(model, config.decoder.pad_id), schedule,
                          weight_decay=0.01, clip_norm=1.0)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)

    def batch(imgs, toks, step):
        idx = draw_indices(gen, dataset_size, batch_size, dev, batch_indices, step)
        images = imgs[idx].to(torch.float32) / 255.0
        if noise > 0:
            images = add_noise(images, noise, gen, batch_noise, step)
        return images, toks[idx]

    # the next block renders on one background thread while the card
    # trains on this one; seeds key off the refresh boundary step
    prefetch = ThreadPoolExecutor(1) if refresh_every else None

    def submit(boundary):
        return prefetch.submit(render_block, config, tokenizer, seed + 1 + boundary,
                               dataset_size, **ds_kwargs)

    pending = submit(refresh_every) if prefetch and steps > refresh_every else None
    done = 0
    next_refresh = refresh_every
    try:
        while done < steps:
            if refresh_every and done >= next_refresh:
                imgs_np, toks_np = pending.result()
                data_imgs = torch.from_numpy(imgs_np).to(dev)
                data_toks = torch.from_numpy(toks_np).to(dev)
                next_refresh += refresh_every
                pending = submit(next_refresh) if steps > next_refresh else None
                logger.info(f"dataset refreshed at step {done}")
            n = min(steps_per_dispatch, steps - done)
            with trainer.timed(dev):
                block = [trainer.step(*batch(data_imgs, data_toks, done + i)) for i in range(n)]
                mean_loss = float(torch.stack(block).mean())
            if losses is not None:
                losses.extend(float(v) for v in block)
            done += n
            logger.info(f"step {done}/{steps} loss={mean_loss:.4f} "
                        f"({trainer.seconds / done:.3f}s/step)")
            if checkpoint_path and refresh_every and done >= next_refresh:
                save_params(to_flax(model), checkpoint_path)
                logger.info(f"periodic checkpoint at step {done}")
    finally:
        if prefetch:
            if pending is not None:
                pending.cancel()
            prefetch.shutdown(wait=False, cancel_futures=True)

    model.eval()
    # eval on clean renders (no low-resolution degradation)
    eval_dataset = SyntheticWordDataset(
        config, tokenizer, seed=seed + 9999, noise=0.0, rotate_deg=rotate_deg, lowres_p=0.0,
        text_mode=text_mode, font_sizes=font_sizes)
    cer = evaluate_cer(model, eval_dataset, tokenizer, n_samples=eval_samples)
    logger.info(f"final CER={cer:.4f} after {steps} steps")
    params = to_flax(model)
    if checkpoint_path:
        save_params(params, checkpoint_path)
        logger.info(f"saved checkpoint to {checkpoint_path}")
    if timing is not None:
        timing.update(trainer.timing())
    return model, params, cer


def train_recognizer(
    config: Optional[TrOCRConfig] = None,
    steps: int = 1000,
    batch_size: int = 64,
    learning_rate: float = 3e-4,
    warmup_steps: int = 100,
    eval_every: int = 200,
    seed: int = 0,
    checkpoint_path: Optional[str] = None,
    log_every: int = 50,
    *,
    device="cuda",
    init_params=None,
    timing: Optional[dict] = None,
):
    """Train on host batches of ``SyntheticWordDataset(seed=seed)`` (the JAX
    trainer's batches: its init batch is drawn first, as JAX draws it for
    ``model.init``); returns (model, params, cer)."""
    logger = MarieLogger("train-recognizer")
    config = config or TrOCRConfig.fast()
    tokenizer = CharTokenizer()
    assert config.decoder.vocab_size >= tokenizer.vocab_size
    dataset = SyntheticWordDataset(config, tokenizer, seed=seed)

    warmup_steps = min(warmup_steps, max(steps // 10, 1))
    schedule = warmup_cosine_decay_schedule(0.0, learning_rate, warmup_steps,
                                            max(steps, warmup_steps + 1))
    dataset.sample(batch_size)  # the JAX trainer's init batch
    model = init_module(config, None, seed, init_params, device).train()
    dev = next(model.parameters()).device
    trainer = StepTrainer(model, recognizer_loss(model, config.decoder.pad_id), schedule,
                          weight_decay=0.01, clip_norm=1.0)

    for step, (images, tokens, _) in enumerate(dataset.batches(batch_size, steps), start=1):
        with trainer.timed(dev):
            loss = trainer.step(torch.from_numpy(images).to(dev), torch.from_numpy(tokens).to(dev))
        if step % log_every == 0:
            logger.info(f"step {step}/{steps} loss={float(loss):.4f} "
                        f"({trainer.seconds / step:.2f}s/step)")
        if eval_every and step % eval_every == 0:
            model.eval()
            cer = evaluate_cer(model, dataset, tokenizer)
            model.train()
            logger.info(f"step {step}: eval CER={cer:.4f}")

    model.eval()
    cer = evaluate_cer(model, dataset, tokenizer)
    logger.info(f"final CER={cer:.4f} after {steps} steps")
    params = to_flax(model)
    if checkpoint_path:
        save_params(params, checkpoint_path)
        logger.info(f"saved checkpoint to {checkpoint_path}")
    if timing is not None:
        timing.update(trainer.timing())
    return model, params, cer
