"""The port's trainers (``marie_tpu_torch/train/``) against the JAX
package's on the CPU, at tiny widths.

* The generators (``synth_*_page``, ``_encode_pages``, ``gen_page``,
  ``make_batch``) equal JAX's to the bit for three seeds; the splitter's
  ``encode_random_size`` is held by the end-to-end splitter run below
  (JAX keeps it inside its trainer).
* ``optim.py``: the schedule at every step of the layout and the
  reading-order schedules within one float32 ulp of the peak (XLA's
  float32 ``cos`` is off the correctly rounded one by an ulp at some
  steps), ``adamw`` within 1e-6 of ``optax.adamw`` over 5 steps with a
  leaf that gets no gradient, the cross entropy within 1e-6.
* Each trainer's loss within 1e-5 (relative) and every gradient leaf
  within 1e-4 of that leaf's largest magnitude of JAX's
  ``value_and_grad`` of the same loss, on the same tree and batch.  The
  leaves the loss does not depend on (the attention key biases: softmax
  is shift invariant in each row; for the reading-order ranker also the
  score head's and ``ln_f``'s biases, which shift every score alike) get
  rounding noise on both sides: both are held to 1e-6 of the tree's
  largest gradient.
* Each trainer run for 5 steps from JAX's starting tree on JAX's batches:
  parameters within 1e-4 of the JAX trainer's, the held-out metrics equal.
  The invariant leaves move on rounding noise through Adam's normalised
  step: they are held to twice the steps' summed Adam bound (3 x lr).
* ``to_flax`` is ``from_flax``'s inverse on each trainer's tree.
"""

import copy
import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import marie_tpu.train.layout as JL
import marie_tpu.train.reading_order as JR
import marie_tpu_torch.train.layout as TL
import marie_tpu_torch.train.reading_order as TR
from marie_tpu.components.word_tokenizer import HashWordTokenizer as JHash
from marie_tpu.components.word_tokenizer import RollingWordTokenizer as JRolling
from marie_tpu.models import configs as jcfg
from marie_tpu.models.layoutlm import LayoutLMv3ForSequenceClassification as JSeq
from marie_tpu.models.layoutlm import LayoutLMv3ForTokenClassification as JTok
from marie_tpu.models.reading_order import ReadingOrderConfig as JRConfig
from marie_tpu.models.reading_order import ReadingOrderModel as JRModel
from marie_tpu_torch.components.word_tokenizer import HashWordTokenizer, RollingWordTokenizer
from marie_tpu_torch.models import configs as tcfg
from marie_tpu_torch.models.reading_order import ReadingOrderConfig
from marie_tpu_torch.registry.convert import to_flax
from marie_tpu_torch.train import optim
from marie_tpu_torch.train.loop import init_module

SEEDS = (0, 7, 23)
GRAD_REL = 1e-4
LOSS_REL = 1e-5
PARAM_ATOL = 1e-4
NOISE = 1e-6


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (str(k),))
    else:
        yield prefix, np.asarray(tree)


def _leaves(tree):
    return dict(_flat(jax.device_get(tree)))


def _invariant(path, reading_order=False):
    """Leaves the loss does not depend on."""
    if path[-3:-1] == ("kv", "k") and path[-1] == "bias":
        return True
    return reading_order and path[-2:] in (("head", "bias"), ("ln_f", "bias"))


# ---------------------------------------------------------------- generators

@pytest.mark.parametrize("seed", SEEDS)
def test_layout_generators_match_jax(seed):
    for gen, args in (("synth_classified_page", (0,)), ("synth_classified_page", (2,)),
                      ("synth_kv_page", ()), ("synth_split_page", (True,)),
                      ("synth_split_page", (False,))):
        jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
        for _ in range(20):
            assert getattr(JL, gen)(jr, *args) == getattr(TL, gen)(tr, *args), gen
        assert jr.random() == tr.random()  # the generators consumed the same draws
    pages = [JL.synth_kv_page(np.random.default_rng(seed + i))[:2] for i in range(12)]
    for jtok, ttok in ((JHash(8192), HashWordTokenizer(8192)),
                       (JRolling(8192), RollingWordTokenizer(8192))):
        cfg = jcfg.LayoutLMConfig.synth(3)
        for a, b in zip(JL._encode_pages(pages, jtok, cfg),
                        TL._encode_pages(pages, ttok, tcfg.LayoutLMConfig.synth(3))):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", SEEDS)
def test_reading_order_generators_match_jax(seed):
    jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(8):
        a, na = JR.gen_page(jr, 256)
        b, nb = TR.gen_page(tr, 256)
        assert na == nb
        np.testing.assert_array_equal(a, b)
    for a, b in zip(JR.make_batch(jr, 6, 256), TR.make_batch(tr, 6, 256)):
        np.testing.assert_array_equal(a, b)
    assert jr.random() == tr.random()


# ----------------------------------------------------------------- optimiser

@pytest.mark.parametrize("args", [(0.0, 3e-4, 150, 1500), (0.0, 3e-4, 200, 2000),
                                  (0.0, 3e-4, 100, 2900, 1.5e-5),
                                  (0.0, 3e-4, 200, 2800, 1.5e-5), (0.0, 1e-3, 1, 5)])
def test_schedule_matches_optax(args):
    want = np.asarray(jax.vmap(optax.warmup_cosine_decay_schedule(*args))(
        jnp.arange(args[3] + 20, dtype=jnp.int32)))
    sched = optim.warmup_cosine_decay_schedule(*args)
    got = np.asarray([sched(i) for i in range(args[3] + 20)], np.float32)
    assert np.abs(got - want).max() <= np.spacing(np.float32(args[1]))
    assert got[0] == want[0] and (got == want).mean() > 0.98


def test_adamw_matches_optax():
    rng = np.random.default_rng(4)
    shapes = {"a": (5, 3), "b": (7,), "unused": (4, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    sched = optax.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 8)
    tx = optax.adamw(sched, weight_decay=0.01)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    opt = optim.AdamW(tp.values(), optim.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 8),
                      weight_decay=0.01)
    for _ in range(5):
        grads = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
        grads["unused"] = np.zeros(shapes["unused"], np.float32)
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.zero_grad()
        for k in ("a", "b"):
            tp[k].grad = torch.from_numpy(grads[k])
        opt.step()  # "unused" has .grad None: it steps with a zero gradient
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=0,
                                       atol=1e-6)
    assert not np.array_equal(tp["unused"].detach().numpy(), params["unused"])  # decayed


def test_cross_entropy_matches_optax():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((6, 9, 5)).astype(np.float32) * 4
    labels = rng.integers(0, 5, (6, 9)).astype(np.int32)
    want = optax.softmax_cross_entropy_with_integer_labels(jnp.asarray(logits),
                                                           jnp.asarray(labels))
    got = optim.softmax_cross_entropy_with_integer_labels(torch.from_numpy(logits),
                                                          torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


# ----------------------------------------------------------- loss and grads

def _torch_grads(model):
    grads = [p.grad.clone() if p.grad is not None else torch.zeros_like(p)
             for p in model.parameters()]
    g = copy.deepcopy(model)
    with torch.no_grad():
        for p, gr in zip(g.parameters(), grads):
            p.copy_(gr)
    return _leaves(to_flax(g))


def _check_grads(jloss, jgrads, tloss, tgrads, reading_order=False):
    assert abs(float(tloss) - float(jloss)) <= LOSS_REL * abs(float(jloss))
    want = _leaves(jgrads)
    top = max(float(np.abs(v).max()) for v in want.values())
    for path, w in want.items():
        got = tgrads[path]
        if _invariant(path, reading_order):
            assert np.abs(w).max() <= NOISE * top and np.abs(got).max() <= NOISE * top, path
            continue
        assert np.abs(got - w).max() <= GRAD_REL * np.abs(w).max(), path


def _layout_case(head, seed, **kw):
    cfg_j = dataclasses.replace(jcfg.LayoutLMConfig.tiny(5 if head == "token" else 3), **kw)
    cfg_t = dataclasses.replace(tcfg.LayoutLMConfig.tiny(5 if head == "token" else 3), **kw)
    rng = np.random.default_rng(seed)
    l = cfg_j.max_seq_len
    pages, ys = [], []
    for i in range(6):
        if head == "token":
            words, boxes, bio = JL.synth_kv_page(rng)
            row = np.zeros((l,), np.int32)
            row[:min(len(bio), l)] = bio[:l]
            ys.append(row)
        else:
            words, boxes = JL.synth_classified_page(rng, i % 3)
            ys.append(i % 3)
        pages.append((words, boxes))
    tok, bx, sl = JL._encode_pages(pages, JHash(cfg_j.vocab_size), cfg_j)
    return cfg_j, cfg_t, (tok, bx, sl, np.asarray(ys, np.int32))


@pytest.mark.parametrize("head,kw", [("sequence", {}), ("token", {}),
                                     ("sequence", {"use_image": False, "max_seq_len": 96})])
def test_layout_loss_and_grads_match_jax(head, kw):
    cfg_j, cfg_t, data = _layout_case(head, 11, **kw)
    jmodel = (JSeq if head == "sequence" else JTok)(cfg_j)
    l = cfg_j.max_seq_len
    params = jmodel.init(jax.random.PRNGKey(11), jnp.zeros((1, l), jnp.int32),
                         jnp.zeros((1, l, 4), jnp.int32), jnp.ones((1,), jnp.int32), None)
    toks, bxs, lens, ys = (jnp.asarray(a) for a in data)

    def loss_fn(p):  # the JAX trainers' losses (train/layout.py)
        logits = jmodel.apply(p, toks, bxs, lens, None)
        per = optax.softmax_cross_entropy_with_integer_labels(logits, ys)
        if head == "sequence":
            return per.mean()
        mask = (jnp.arange(logits.shape[1])[None, :] < lens[:, None]).astype(jnp.float32)
        return (per * mask).sum() / jnp.maximum(mask.sum(), 1.0)

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    model = init_module(cfg_t, head, 0, jax.device_get(params), "cpu")
    loss = TL.head_loss(model, head)(*(torch.from_numpy(a) for a in data))
    loss.backward()
    _check_grads(jloss, jgrads, loss.detach(), _torch_grads(model))
    if cfg_t.use_image:  # JAX makes no patch_embed without an image; vis_pos gets 0
        assert float(np.abs(_torch_grads(model)[("params", "encoder", "vis_pos")]).max()) == 0


def test_reading_order_loss_and_grads_match_jax():
    rng = np.random.default_rng(12)
    boxes, ranks, n_valid = JR.make_batch(rng, 4, 256)
    jmodel = JRModel(JRConfig.tiny())
    params = jmodel.init(jax.random.PRNGKey(12), jnp.asarray(boxes), jnp.asarray(n_valid))

    def loss_fn(p):
        return JR.pairwise_rank_loss(jmodel.apply(p, jnp.asarray(boxes), jnp.asarray(n_valid)),
                                     jnp.asarray(ranks), jnp.asarray(n_valid))

    (jloss, jacc), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    model = init_module(ReadingOrderConfig.tiny(), None, 0, jax.device_get(params), "cpu")
    b, r, n = (torch.from_numpy(a) for a in (boxes, ranks, n_valid))
    loss, acc = TR.pairwise_rank_loss(model(b, n), r, n)
    loss.backward()
    assert float(acc) == float(jacc)
    _check_grads(jloss, jgrads, loss.detach(), _torch_grads(model), reading_order=True)
