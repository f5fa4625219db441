"""Training of the LayoutLM heads on synthetic labelled documents (port of
``marie_tpu/train/layout.py``).

* Splitter: boundary pages open with a letterhead and usually "page 1 of
  N", continuation pages carry "page k of N" and sometimes "continued".
* Classifier: pages drawn from class keyword pools (invoice /
  correspondence / claim) mixed with shared filler.
* Indexer (NER): "Field Name: value" forms with BIO labels from their
  construction.

The generators are copies of the JAX package's and draw from the numpy
``rng`` in the same order, so a seed gives the same datasets and held-out
sets to the bit.  The dataset is uploaded once; each step draws its batch
indices on the device from an explicit ``torch.Generator`` (one
``randint`` a step; JAX draws them from ``jax.random``, which the port
cannot repeat) and runs the forward, K2's gradient on the card
(``ops/kernels/flash_attention.py``) and :class:`~marie_tpu_torch.train.
optim.AdamW`, all in float32 without TF32, with the kernels counted on the
``"train"`` launch path.  Nothing reads a value back a step: the loss of a
block of ``steps_per_dispatch`` steps is read where the JAX loop logs it
(``done % 250 == 0``).

Each trainer takes the JAX trainer's arguments and returns what it
returns, with the torch module in place of the flax module and its
flax-layout tree (:func:`registry.convert.to_flax`) as ``params``.  Four
keywords are the port's: ``device`` (the card unless the caller asks for
the CPU), ``init_params`` (a flax-layout tree to start from in place of
the seeded draw of :func:`registry.convert.init_flax_defaults`; leaves it
lacks keep their draw) and ``batch_indices`` (one index array a step in
place of the device draws), which the CPU tests use to hand the port the
JAX trainer's starting tree and batches; and ``timing``, a dict the
trainer fills with its step count, seconds and ms a step.
"""

import time
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from marie_tpu_torch.components.word_tokenizer import HashWordTokenizer
from marie_tpu_torch.logging_core import MarieLogger
from marie_tpu_torch.models.configs import LayoutLMConfig
from marie_tpu_torch.ops.kernels._build import launch_path
from marie_tpu_torch.registry.checkpoints import save_params
from marie_tpu_torch.registry.convert import to_flax
from marie_tpu_torch.train.loop import StepTrainer, init_module
from marie_tpu_torch.train.optim import (
    softmax_cross_entropy_with_integer_labels,
    warmup_cosine_decay_schedule,
)
from marie_tpu_torch.utils.device import float32_precision

CLASS_POOLS: Dict[str, List[str]] = {
    "invoice": "invoice subtotal tax total remit payment terms net due bill".split(),
    "correspondence": "dear sincerely regards letter notice inform request please".split(),
    "claim": "claim member patient provider diagnosis procedure benefit copay".split(),
}
_FILLER = "the and for with from of on at this that company date page".split()

KEY_POOL = "name address phone date amount total account member policy".split()


def _random_value(rng) -> str:
    kind = rng.integers(0, 3)
    if kind == 0:
        return f"{rng.integers(0, 100000) / 100:.2f}"
    if kind == 1:
        return f"{rng.integers(1, 13):02d}/{rng.integers(1, 29):02d}/{rng.integers(1990, 2030)}"
    return f"ID{rng.integers(10000, 99999)}"


def synth_classified_page(rng, label_idx: int, n_words: int = 60):
    """-> (words, boxes): ~40% of the words from the class's pool, the
    rest filler; boxes xywh page pixels."""
    pool = list(CLASS_POOLS.values())[label_idx]
    words, boxes = [], []
    x, y = 20, 20
    for _ in range(n_words):
        w = pool[rng.integers(0, len(pool))] if rng.random() < 0.4 else (
            _FILLER[rng.integers(0, len(_FILLER))]
        )
        words.append(w)
        bw = 8 * len(w) + 4
        boxes.append([x, y, bw, 14])
        x += bw + 10
        if x > 700:
            x, y = 20, y + 24
    return words, boxes


def synth_kv_page(rng, n_pairs: int = 12):
    """-> (words, boxes, bio_labels) for 'Key Name : value' lines.

    labels: 0=O, 1=B-KEY, 2=I-KEY, 3=B-VALUE, 4=I-VALUE.
    """
    words, boxes, labels = [], [], []
    y = 20
    for _ in range(n_pairs):
        x = 20
        key_len = int(rng.integers(1, 3))
        for i in range(key_len):
            w = KEY_POOL[rng.integers(0, len(KEY_POOL))]
            words.append(w)
            boxes.append([x, y, 8 * len(w) + 4, 14])
            labels.append(1 if i == 0 else 2)
            x += 8 * len(w) + 12
        # a filler word between some pairs (O)
        if rng.random() < 0.3:
            f = _FILLER[rng.integers(0, len(_FILLER))]
            words.append(f)
            boxes.append([x, y, 8 * len(f) + 4, 14])
            labels.append(0)
            x += 8 * len(f) + 12
        val = _random_value(rng)
        words.append(val)
        boxes.append([x, y, 8 * len(val) + 4, 14])
        labels.append(3)
        y += 26
    return words, boxes, labels


HEADER_POOL = (
    "invoice statement claim notice memo corporation llc incorporated "
    "street suite attn regarding dear account summary remittance"
).split()
_CONT_POOL = "continued carried forward subtotal".split()


def synth_split_page(rng, is_boundary: bool, n_body_words: int = 50):
    """-> (words, boxes) for splitter training: a boundary (first) page
    opens with a letterhead block and usually 'page 1 of N'; a
    continuation page carries 'page k of N' (k > 1) and sometimes
    'continued'; then body filler."""
    words, boxes = [], []
    y = 16

    def put_line(line_words, y):
        x = 20
        for w in line_words:
            words.append(w)
            boxes.append([x, y, 8 * len(w) + 4, 14])
            x += 8 * len(w) + 12
        return y + 24

    total = int(rng.integers(2, 9))
    if is_boundary:
        for _ in range(int(rng.integers(2, 4))):  # letterhead block
            line = [
                HEADER_POOL[rng.integers(0, len(HEADER_POOL))]
                for _ in range(int(rng.integers(2, 5)))
            ]
            y = put_line(line, y)
        if rng.random() < 0.7:
            y = put_line(["page", "1", "of", str(total)], y)
    else:
        k = int(rng.integers(2, total + 1)) if total >= 2 else 2
        if rng.random() < 0.6:
            y = put_line(["page", str(k), "of", str(total)], y)
        if rng.random() < 0.5:
            y = put_line([_CONT_POOL[rng.integers(0, len(_CONT_POOL))]], y)
    # body filler
    x = 20
    for _ in range(n_body_words):
        w = _FILLER[rng.integers(0, len(_FILLER))]
        words.append(w)
        boxes.append([x, y, 8 * len(w) + 4, 14])
        x += 8 * len(w) + 12
        if x > 700:
            x, y = 20, y + 24
    return words, boxes


def encode_random_size(pages_list, rng, tokenizer, config: LayoutLMConfig):
    """The splitter's encoding: each page with a RANDOM page size (drawn
    from ``rng``), so the head does not learn one physical page size.
    -> (tokens [N, L], boxes [N, L, 4], seq_len [N]) int32."""
    l = config.max_seq_len
    n = len(pages_list)
    tokens = np.zeros((n, l), np.int32)
    boxes_arr = np.zeros((n, l, 4), np.int32)
    seq_len = np.ones((n,), np.int32)
    for i, (words, wboxes) in enumerate(pages_list):
        ps = (int(rng.integers(600, 1400)), int(rng.integers(300, 1400)))
        t, b, ln = tokenizer.encode_page(words, wboxes, ps, l, config.max_2d_pos)
        tokens[i], boxes_arr[i], seq_len[i] = t, b, max(ln, 1)
    return tokens, boxes_arr, seq_len


def _encode_pages(pages, tokenizer, cfg, page_size=(760, 400)):
    l = cfg.max_seq_len
    n = len(pages)
    tokens = np.zeros((n, l), np.int32)
    boxes = np.zeros((n, l, 4), np.int32)
    seq_len = np.ones((n,), np.int32)
    for i, (words, wboxes) in enumerate(pages):
        t, b, ln = tokenizer.encode_page(words, wboxes, page_size, l, cfg.max_2d_pos)
        tokens[i], boxes[i], seq_len[i] = t, b, max(ln, 1)
    return tokens, boxes, seq_len


def head_loss(model, head: str):
    """The JAX trainers' losses: mean cross entropy of the page logits
    (``"sequence"``), or of the token logits over each page's valid tokens
    (``"token"``).  ``loss_fn(tokens, boxes, seq_len, labels)``."""

    def loss_fn(toks, bxs, lens, ys):
        logits = model(toks, bxs, lens, None)
        per = softmax_cross_entropy_with_integer_labels(logits, ys)
        if head == "sequence":
            return per.mean()
        mask = (torch.arange(logits.shape[1], device=logits.device)[None, :]
                < lens[:, None]).to(torch.float32)
        return (per * mask).sum() / torch.clamp(mask.sum(), min=1.0)

    return loss_fn


def train_head(model, head: str, data, *, steps: int, batch_size: int, dataset_size: int,
                learning_rate: float, steps_per_dispatch: int, seed: int, logger,
                batch_indices: Optional[Iterable] = None) -> StepTrainer:
    """The JAX trainers' loop: warmup + cosine to ``steps`` (warmup a
    tenth), AdamW with weight decay 0.01, ``steps_per_dispatch`` steps a
    block until ``steps`` are done (a partial last block runs whole, as the
    JAX loop's), the block's mean loss logged at every 250th step."""
    dev = next(model.parameters()).device
    toks, bxs, lens, ys = (torch.as_tensor(a, device=dev) for a in data)
    schedule = warmup_cosine_decay_schedule(0.0, learning_rate, max(steps // 10, 1), steps)
    trainer = StepTrainer(model, head_loss(model, head), schedule, weight_decay=0.01)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    given = iter(batch_indices) if batch_indices is not None else None
    t0 = time.time()
    done = 0
    while done < steps:
        with trainer.timed(dev):
            block = torch.zeros((), device=dev)
            for _ in range(steps_per_dispatch):
                if given is None:
                    idx = torch.randint(0, dataset_size, (batch_size,), generator=gen, device=dev)
                else:
                    idx = torch.as_tensor(np.array(next(given)), device=dev).long()
                block = block + trainer.step(toks[idx], bxs[idx], lens[idx], ys[idx])
        done += steps_per_dispatch
        if done % 250 == 0:
            logger.info(f"step {done}/{steps} loss={float(block) / steps_per_dispatch:.4f} "
                        f"({(time.time() - t0) / done:.3f}s/step)")
    return trainer


@torch.no_grad()
def predict(model, tokens, boxes, seq_len) -> np.ndarray:
    """The model's logits on numpy inputs, as numpy (one forward, float32
    matmuls, on the ``"train"`` path)."""
    dev = next(model.parameters()).device
    with float32_precision(False), launch_path("train"):
        out = model(*(torch.as_tensor(a, device=dev) for a in (tokens, boxes, seq_len)), None)
    return out.cpu().numpy()


def _finish(model, checkpoint_path: Optional[str], logger, trainer, timing):
    tree = to_flax(model)
    if checkpoint_path:
        save_params(tree, checkpoint_path)
        logger.info(f"saved to {checkpoint_path}")
    if timing is not None:
        timing.update(trainer.timing())
    return tree


def splitter_dataset(rng, dataset_size: int, tokenizer, config):
    """The splitter's training set: (tokens, boxes, seq_len, labels), a
    boundary page (label 1) with probability 0.5."""
    pages, ys = [], []
    for _ in range(dataset_size):
        is_boundary = bool(rng.random() < 0.5)
        pages.append(synth_split_page(rng, is_boundary))
        ys.append(int(is_boundary))
    return (*encode_random_size(pages, rng, tokenizer, config), np.asarray(ys, np.int32))


def splitter_heldout(rng, tokenizer, config):
    """The splitter's held-out set, drawn after its training set: 64
    bundles of 2-4 documents of 1-4 pages -> (tokens, boxes, seq_len,
    labels, bundles of page indices)."""
    test_pages, test_ys, bundles = [], [], []
    for _ in range(64):
        bundle = []
        for _ in range(int(rng.integers(2, 5))):
            n_pages_doc = int(rng.integers(1, 5))
            for p in range(n_pages_doc):
                bundle.append(len(test_pages))
                is_boundary = p == 0
                test_pages.append(synth_split_page(rng, is_boundary))
                test_ys.append(int(is_boundary))
        bundles.append(bundle)
    return (*encode_random_size(test_pages, rng, tokenizer, config), test_ys, bundles)


def splitter_metrics(pred, test_ys, bundles) -> Dict[str, float]:
    """Page accuracy and whole-bundle split accuracy of predicted labels
    (the first page of a bundle always starts a document)."""
    page_acc = float((np.asarray(pred) == np.asarray(test_ys)).mean())
    bundle_ok = 0
    for bundle in bundles:
        truth = [test_ys[i] for i in bundle]
        got = [int(pred[i]) for i in bundle]
        got[0] = 1  # first page always a boundary (splitter semantics)
        truth[0] = 1
        bundle_ok += int(got == truth)
    return {"page_acc": page_acc, "split_acc": bundle_ok / max(len(bundles), 1)}


def _shuffled(rng, words, boxes, *rest):
    perm = rng.permutation(len(words))
    return ([words[j] for j in perm], [boxes[j] for j in perm],
            *([r[j] for j in perm] for r in rest))


def classifier_dataset(rng, n: int, labels, tokenizer, config, shuffle_words: bool):
    """``n`` classified pages (a uniform label each), encoded:
    (tokens, boxes, seq_len, labels); the held-out set is the next 256."""
    pages, ys = [], []
    for _ in range(n):
        li = int(rng.integers(0, len(labels)))
        words, boxes = synth_classified_page(rng, li)
        if shuffle_words:
            words, boxes = _shuffled(rng, words, boxes)
        pages.append((words, boxes))
        ys.append(li)
    return (*_encode_pages(pages, tokenizer, config), np.asarray(ys, np.int32))


def indexer_dataset(rng, n: int, tokenizer, config, shuffle_words: bool):
    """``n`` key-value pages, encoded: (tokens, boxes, seq_len, BIO tags
    [n, L]); the held-out set is the next 128."""
    l = config.max_seq_len
    pages, tags = [], []
    for _ in range(n):
        words, boxes, bio = synth_kv_page(rng)
        if shuffle_words:
            words, boxes, bio = _shuffled(rng, words, boxes, bio)
        pages.append((words, boxes))
        row = np.zeros((l,), np.int32)
        row[: min(len(bio), l)] = bio[:l]
        tags.append(row)
    return (*_encode_pages(pages, tokenizer, config), np.stack(tags))


def token_accuracy(pred, tokens_data) -> float:
    """Share of the valid tokens (below each page's seq_len) whose
    predicted tag equals the truth."""
    _, _, seq_len, tags = tokens_data
    correct = total = 0
    for i, n in enumerate(seq_len):
        correct += int((pred[i, :n] == tags[i, :n]).sum())
        total += int(n)
    return correct / max(total, 1)


def train_layout_splitter(
    config: Optional[LayoutLMConfig] = None,
    steps: int = 1500,
    batch_size: int = 32,
    dataset_size: int = 2048,
    learning_rate: float = 3e-4,
    steps_per_dispatch: int = 25,
    seed: int = 0,
    checkpoint_path: Optional[str] = None,
    *,
    device="cuda",
    init_params=None,
    batch_indices: Optional[Iterable] = None,
    timing: Optional[dict] = None,
):
    """Train the page boundary/continuation head behind
    ``LayoutDocumentSplitter``.  -> (model, params, {"page_acc",
    "split_acc"}, config); ``checkpoint_path`` gets a ``.npz`` tree."""
    logger = MarieLogger("train-splitter")
    labels = ("continuation", "boundary")
    config = config or LayoutLMConfig.synth(num_labels=len(labels))
    tokenizer = HashWordTokenizer(config.vocab_size)
    rng = np.random.default_rng(seed)
    data = splitter_dataset(rng, dataset_size, tokenizer, config)
    model = init_module(config, "sequence", seed, init_params, device)
    trainer = train_head(
        model, "sequence", data, steps=steps, batch_size=batch_size,
        dataset_size=dataset_size, learning_rate=learning_rate,
        steps_per_dispatch=steps_per_dispatch, seed=seed, logger=logger,
        batch_indices=batch_indices)
    tt, tb, tl, test_ys, bundles = splitter_heldout(rng, tokenizer, config)
    metrics = splitter_metrics(predict(model, tt, tb, tl).argmax(-1), test_ys, bundles)
    logger.info(f"held-out page accuracy={metrics['page_acc']:.4f} "
                f"split accuracy={metrics['split_acc']:.4f}")
    params = _finish(model, checkpoint_path, logger, trainer, timing)
    return model, params, metrics, config


def train_layout_classifier(
    labels: Sequence[str] = tuple(CLASS_POOLS),
    config: Optional[LayoutLMConfig] = None,
    steps: int = 1500,
    batch_size: int = 32,
    dataset_size: int = 2048,
    learning_rate: float = 3e-4,
    steps_per_dispatch: int = 25,
    seed: int = 0,
    checkpoint_path: Optional[str] = None,
    tokenizer=None,
    shuffle_words: bool = False,
    *,
    device="cuda",
    init_params=None,
    batch_indices: Optional[Iterable] = None,
    timing: Optional[dict] = None,
):
    """Train the page classifier.  ``shuffle_words`` permutes each page's
    words, so the head reads layout from the boxes rather than the
    sequence position (the fused chain feeds words in CC-slot order).
    -> (model, params, held-out accuracy, config)."""
    logger = MarieLogger("train-classifier")
    config = config or LayoutLMConfig.synth(len(labels))
    tokenizer = tokenizer or HashWordTokenizer(config.vocab_size)
    rng = np.random.default_rng(seed)
    data = classifier_dataset(rng, dataset_size, labels, tokenizer, config, shuffle_words)
    model = init_module(config, "sequence", seed, init_params, device)
    trainer = train_head(
        model, "sequence", data, steps=steps, batch_size=batch_size,
        dataset_size=dataset_size, learning_rate=learning_rate,
        steps_per_dispatch=steps_per_dispatch, seed=seed, logger=logger,
        batch_indices=batch_indices)
    tt, tb, tl, test_ys = classifier_dataset(rng, 256, labels, tokenizer, config, shuffle_words)
    acc = float((predict(model, tt, tb, tl).argmax(-1) == test_ys).mean())
    logger.info(f"held-out accuracy={acc:.4f}")
    params = _finish(model, checkpoint_path, logger, trainer, timing)
    return model, params, acc, config


def train_layout_indexer(
    labels: Sequence[str] = ("O", "B-KEY", "I-KEY", "B-VALUE", "I-VALUE"),
    config: Optional[LayoutLMConfig] = None,
    steps: int = 1500,
    batch_size: int = 32,
    dataset_size: int = 2048,
    learning_rate: float = 3e-4,
    steps_per_dispatch: int = 25,
    seed: int = 0,
    checkpoint_path: Optional[str] = None,
    tokenizer=None,
    shuffle_words: bool = False,
    *,
    device="cuda",
    init_params=None,
    batch_indices: Optional[Iterable] = None,
    timing: Optional[dict] = None,
):
    """Train the NER / key-value head (BIO tags).  -> (model, params,
    held-out token accuracy, config)."""
    logger = MarieLogger("train-indexer")
    config = config or LayoutLMConfig.synth(len(labels))
    tokenizer = tokenizer or HashWordTokenizer(config.vocab_size)
    rng = np.random.default_rng(seed)
    data = indexer_dataset(rng, dataset_size, tokenizer, config, shuffle_words)
    model = init_module(config, "token", seed, init_params, device)
    trainer = train_head(
        model, "token", data, steps=steps, batch_size=batch_size,
        dataset_size=dataset_size, learning_rate=learning_rate,
        steps_per_dispatch=steps_per_dispatch, seed=seed, logger=logger,
        batch_indices=batch_indices)
    held = indexer_dataset(rng, 128, tokenizer, config, shuffle_words)
    acc = token_accuracy(predict(model, *held[:3]).argmax(-1), held)
    logger.info(f"held-out token accuracy={acc:.4f}")
    params = _finish(model, checkpoint_path, logger, trainer, timing)
    return model, params, acc, config
