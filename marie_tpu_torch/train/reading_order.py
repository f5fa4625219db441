"""Training of the reading-order ranker on synthetic layouts (port of
``marie_tpu/train/reading_order.py``).

Pages of the kinds ReadingBank covers (one to three columns, a header
over two columns, row-major tables) are drawn with their true reading
order, shuffled, and the one-pass ranker of :mod:`marie_tpu_torch.models.
reading_order` learns, through a pairwise logistic loss, to score boxes
so that the stable argsort of the scores is the reading order.  The
generators are copies of the JAX package's and consume the numpy ``rng``
in the same order: a seed gives the same pages and batches to the bit.

:func:`train_reading_order` makes each batch on the host from that
``rng`` (the same batches as the JAX trainer); :func:`train_reading_order_
device` keeps a pool of pages on the card and draws each step's pages and
their shuffle there from a ``torch.Generator`` (JAX draws them from
``jax.random``).  Both step the model (K2 at D=32 and its gradient on the
card, AdamW, float32 without TF32) on the ``"train"`` launch path, and
take the port's keywords ``device``, ``init_params`` and ``timing`` as
the layout trainers do (``marie_tpu_torch/train/layout.py``).
"""

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from marie_tpu_torch.models.reading_order import ReadingOrderConfig
from marie_tpu_torch.ops.kernels._build import launch_path
from marie_tpu_torch.registry.checkpoints import save_params
from marie_tpu_torch.registry.convert import to_flax
from marie_tpu_torch.train.loop import StepTrainer, init_module
from marie_tpu_torch.train.optim import warmup_cosine_decay_schedule
from marie_tpu_torch.utils.device import float32_precision


# ----------------------------------------------------------------------
# synthetic layout generation (ReadingBank-style pages, known order)
# ----------------------------------------------------------------------

def _gen_column_words(rng, x0, x1, y0, y1, word_h):
    """Lines of words filling [x0,x1]x[y0,y1] top-to-bottom,
    left-to-right: word boxes, or (three times in ten) one box a line, with
    line spacing from tight to sparse."""
    boxes = []
    y = y0
    line_gap = word_h * rng.uniform(0.3, 2.5)
    line_mode = rng.random() < 0.3  # one box per line (line-level ordering)
    while y + word_h <= y1:
        jy = rng.uniform(-0.15, 0.15) * word_h
        if line_mode:
            w = rng.uniform(0.5, 1.0) * (x1 - x0)
            boxes.append([x0, y + jy, x0 + w, y + jy + word_h])
        else:
            x = x0
            while x < x1 - 0.01:
                w = rng.uniform(0.02, 0.12) * (x1 - x0) / 0.3
                w = min(w, x1 - x)
                if w < 0.008:
                    break
                boxes.append([x, y + jy, x + w, y + jy + word_h])
                x += w + rng.uniform(0.004, 0.02)
        y += word_h + line_gap
    return boxes


def _gen_table_words(rng, y0, y1):
    """Row-major table: reading order is row by row, cell by cell."""
    rows = rng.integers(3, 8)
    cols = rng.integers(2, 5)
    boxes = []
    row_h = (y1 - y0) / rows
    col_w = 0.9 / cols
    for r in range(rows):
        for c in range(cols):
            cx0 = 0.05 + c * col_w + rng.uniform(0.0, 0.01)
            cy0 = y0 + r * row_h + rng.uniform(0.0, 0.1) * row_h
            w = rng.uniform(0.3, 0.8) * col_w
            h = rng.uniform(0.3, 0.6) * row_h
            boxes.append([cx0, cy0, cx0 + w, cy0 + h])
    return boxes


def gen_page(rng, max_boxes: int) -> Tuple[np.ndarray, int]:
    """One synthetic page -> (boxes [max_boxes, 4] xyxy in [0, 1], n_valid),
    the boxes IN reading order (the caller shuffles): one column, two or
    three columns, a header block over two columns, or a table."""
    kind = rng.integers(0, 5)
    word_h = rng.uniform(0.01, 0.045)
    boxes = []
    y_top = rng.uniform(0.03, 0.1)
    if kind == 0:  # single column
        boxes = _gen_column_words(rng, 0.06, 0.94, y_top, 0.95, word_h)
    elif kind in (1, 2):  # 2 or 3 columns, column-major reading
        ncol = kind + 1
        gap = rng.uniform(0.02, 0.14)
        cw = (0.88 - gap * (ncol - 1)) / ncol
        y_bot = rng.uniform(0.45, 0.95)
        for c in range(ncol):
            cx0 = 0.06 + c * (cw + gap)
            boxes.extend(
                _gen_column_words(rng, cx0, cx0 + cw, y_top, y_bot, word_h)
            )
    elif kind == 3:  # full-width header block, then two columns
        hdr_bot = y_top + rng.uniform(0.05, 0.12)
        boxes = _gen_column_words(rng, 0.06, 0.94, y_top, hdr_bot, word_h * 1.4)
        gap = 0.03
        cw = (0.88 - gap) / 2
        for c in range(2):
            cx0 = 0.06 + c * (cw + gap)
            boxes.extend(
                _gen_column_words(rng, cx0, cx0 + cw, hdr_bot + 0.03, 0.95, word_h)
            )
    else:  # table
        boxes = _gen_table_words(rng, y_top, rng.uniform(0.6, 0.95))

    boxes = boxes[:max_boxes]
    n = len(boxes)
    out = np.zeros((max_boxes, 4), np.float32)
    if n:
        out[:n] = np.asarray(boxes, np.float32)
    return out, n


def make_batch(rng, batch: int, max_boxes: int):
    """Shuffled batch: (boxes [B,N,4], ranks [B,N] int32, n_valid [B])."""
    boxes = np.zeros((batch, max_boxes, 4), np.float32)
    ranks = np.zeros((batch, max_boxes), np.int32)
    n_valid = np.zeros((batch,), np.int32)
    for b in range(batch):
        page, n = gen_page(rng, max_boxes)
        n = max(n, 2)
        perm = rng.permutation(n)
        boxes[b, :n] = page[perm]
        ranks[b, :n] = perm  # row i is reading-position perm[i]
        ranks[b, n:] = max_boxes + 1  # pads rank after everything
        n_valid[b] = n
    return boxes, ranks, n_valid


# ----------------------------------------------------------------------
# loss / metrics
# ----------------------------------------------------------------------

def pairwise_rank_loss(scores, ranks, n_valid):
    """Logistic loss over all valid ordered pairs (wants s_i < s_j when box
    i reads before box j) -> (loss, pair accuracy), both 0-d tensors."""
    n = scores.shape[1]
    pos = torch.arange(n, device=scores.device)
    valid = pos[None, :] < n_valid[:, None]  # [B,N]
    pair_valid = valid[:, :, None] & valid[:, None, :]
    before = ranks[:, :, None] < ranks[:, None, :]  # i reads before j
    mask = (pair_valid & before).to(torch.float32)
    diff = scores[:, :, None] - scores[:, None, :]  # want negative
    loss = F.softplus(diff) * mask
    correct = ((diff < 0) & (mask > 0)).to(torch.float32)
    denom = torch.clamp(mask.sum(), min=1.0)
    return loss.sum() / denom, correct.sum() / denom


def kendall_tau(order_pred: np.ndarray, order_true: np.ndarray) -> float:
    """Kendall rank correlation between two permutations of 0..n-1."""
    n = len(order_pred)
    if n < 2:
        return 1.0
    pos_pred = np.empty(n, np.int64)
    pos_pred[order_pred] = np.arange(n)
    pos_true = np.empty(n, np.int64)
    pos_true[order_true] = np.arange(n)
    a = pos_pred[:, None] < pos_pred[None, :]
    b = pos_true[:, None] < pos_true[None, :]
    iu = np.triu_indices(n, 1)
    agree = (a[iu] == b[iu]).sum()
    total = len(iu[0])
    return float(2.0 * agree / total - 1.0)


# ----------------------------------------------------------------------
# training
# ----------------------------------------------------------------------

def _rank_trainer(model, steps: int, lr: float, warmup_cap: int) -> StepTrainer:
    """AdamW (weight decay 1e-4) on warmup + cosine to 5% of ``lr``; the
    cosine's ``decay_steps`` is ``steps - warmup`` as the JAX trainers
    pass it (optax counts the warmup in it, so the cosine reaches its end
    ``warmup`` steps early)."""
    warmup = min(warmup_cap, max(steps // 10, 1))
    sched = warmup_cosine_decay_schedule(0.0, lr, warmup, max(steps - warmup, 1), lr * 0.05)

    def loss_fn(boxes, ranks, n_valid):
        return pairwise_rank_loss(model(boxes, n_valid), ranks, n_valid)

    return StepTrainer(model, loss_fn, sched, weight_decay=1e-4)


def _save(model, checkpoint_path, trainer, timing):
    if checkpoint_path:
        save_params(to_flax(model), checkpoint_path)
    if timing is not None:
        timing.update(trainer.timing())


def train_reading_order(
    steps: int = 3000,
    batch_size: int = 32,
    config: Optional[ReadingOrderConfig] = None,
    lr: float = 3e-4,
    seed: int = 0,
    checkpoint_path: Optional[str] = None,
    log_every: int = 200,
    *,
    device="cuda",
    init_params=None,
    timing: Optional[dict] = None,
):
    """Train on host batches from ``np.random.default_rng(seed)``.  Returns
    (model, params, final pairwise accuracy, eval mean tau); ``params`` is
    the trained flax-layout tree."""
    cfg = config or ReadingOrderConfig.base()
    rng = np.random.default_rng(seed)
    make_batch(rng, batch_size, cfg.max_boxes)  # the JAX trainer's init batch
    model = init_module(cfg, None, seed, init_params, device)
    dev = next(model.parameters()).device
    trainer = _rank_trainer(model, steps, lr, 100)

    acc = torch.zeros(())
    for i in range(steps):
        boxes, ranks, n_valid = make_batch(rng, batch_size, cfg.max_boxes)
        with trainer.timed(dev):
            loss, acc = trainer.step(*(torch.from_numpy(a).to(dev)
                                       for a in (boxes, ranks, n_valid)))
        if log_every and (i % log_every == 0 or i == steps - 1):
            print(f"step {i}: loss={float(loss):.4f} pair_acc={float(acc):.4f}", flush=True)

    tau = evaluate_reading_order(model, cfg, seed=seed + 1)
    _save(model, checkpoint_path, trainer, timing)
    return model, to_flax(model), float(acc), tau


def train_reading_order_device(
    steps: int = 4000,
    batch_size: int = 64,
    pool_pages: int = 4096,
    steps_per_dispatch: int = 500,
    config: Optional[ReadingOrderConfig] = None,
    lr: float = 3e-4,
    seed: int = 0,
    checkpoint_path: Optional[str] = None,
    *,
    device="cuda",
    init_params=None,
    timing: Optional[dict] = None,
):
    """Device-resident training: a pool of ``pool_pages`` pages is made on
    the host once and uploaded; each step draws ``batch_size`` pages and a
    shuffle of each on the device, ``steps_per_dispatch`` steps a block
    (the last step's loss and accuracy read at each block's end).  Returns
    (model, params, final pairwise accuracy, eval mean tau)."""
    cfg = config or ReadingOrderConfig.base()
    rng = np.random.default_rng(seed)
    nb = cfg.max_boxes

    pool_boxes = np.zeros((pool_pages, nb, 4), np.float32)
    pool_n = np.zeros((pool_pages,), np.int32)
    for p in range(pool_pages):
        page, n = gen_page(rng, nb)
        pool_boxes[p] = page
        pool_n[p] = max(n, 2)

    model = init_module(cfg, None, seed, init_params, device)
    dev = next(model.parameters()).device
    trainer = _rank_trainer(model, steps, lr, 200)
    pb = torch.from_numpy(pool_boxes).to(dev)
    pn = torch.from_numpy(pool_n).to(dev)
    pos = torch.arange(nb, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 7)

    def batch():
        idx = torch.randint(0, pool_pages, (batch_size,), generator=gen, device=dev)
        page, n = pb[idx], pn[idx]
        u = torch.rand((batch_size, nb), generator=gen, device=dev)
        u = u + (pos[None, :] >= n[:, None]) * 1e9
        perm = torch.argsort(u, dim=1, stable=True)
        boxes = torch.take_along_dim(page, perm[:, :, None], dim=1)
        ranks = torch.where(pos[None, :] < n[:, None], perm, nb + 1).to(torch.int32)
        return boxes, ranks, n

    acc = torch.zeros(())
    done = 0
    while done < steps:
        with trainer.timed(dev):
            for _ in range(steps_per_dispatch):
                loss, acc = trainer.step(*batch())
        done += steps_per_dispatch
        print(f"step {done}: loss={float(loss):.4f} pair_acc={float(acc):.4f}", flush=True)

    tau = evaluate_reading_order(model, cfg, seed=seed + 1)
    _save(model, checkpoint_path, trainer, timing)
    return model, to_flax(model), float(acc), tau


@torch.no_grad()
def score_boxes(model, boxes: np.ndarray, n_valid: np.ndarray) -> np.ndarray:
    """Scores [B, N] of boxes [B, N, 4] with valid counts [B] (the JAX
    ``_score_boxes``): one forward, float32 matmuls, on the ``"train"``
    path."""
    dev = next(model.parameters()).device
    with float32_precision(False), launch_path("train"):
        out = model(torch.from_numpy(np.asarray(boxes, np.float32)).to(dev),
                    torch.from_numpy(np.asarray(n_valid, np.int32)).to(dev))
    return out.cpu().numpy()


def evaluate_reading_order(model, cfg: ReadingOrderConfig, pages: int = 64,
                           seed: int = 1) -> float:
    """Mean Kendall tau of the predicted against the true order over
    ``pages`` fresh pages of ``np.random.default_rng(seed)`` (the JAX
    function's, with the module holding its own weights)."""
    rng = np.random.default_rng(seed)
    boxes, ranks, n_valid = make_batch(rng, pages, cfg.max_boxes)
    scores = score_boxes(model, boxes, n_valid)
    taus = []
    for b in range(pages):
        n = int(n_valid[b])
        pred = np.argsort(scores[b, :n], kind="stable")
        true = np.argsort(ranks[b, :n], kind="stable")
        taus.append(kendall_tau(pred, true))
    return float(np.mean(taus))
