"""The port's trainers run for 5 steps against the JAX package's on the
CPU, at tiny widths, from JAX's starting tree and on JAX's batches (the
layout trainers take JAX's batch indices through ``batch_indices``; the
reading-order trainer draws the same host batches from the same numpy
``rng``): parameters within 1e-4 of the JAX trainer's and the held-out
metrics equal.  The leaves the loss does not depend on (see
``tests/test_torch_train.py``) move on rounding noise through Adam's
normalised step, and are held to twice the steps' summed Adam bound
(3 x lr a step).  ``to_flax`` is ``from_flax``'s inverse on each trained
tree, and the saved ``.npz`` reads back equal.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import marie_tpu.train.layout as JL
import marie_tpu.train.reading_order as JR
import marie_tpu_torch.train.layout as TL
import marie_tpu_torch.train.reading_order as TR
from marie_tpu.components.word_tokenizer import RollingWordTokenizer as JRolling
from marie_tpu.models import configs as jcfg
from marie_tpu.models.layoutlm import LayoutLMv3ForSequenceClassification as JSeq
from marie_tpu.models.layoutlm import LayoutLMv3ForTokenClassification as JTok
from marie_tpu.models.reading_order import ReadingOrderConfig as JRConfig
from marie_tpu.models.reading_order import ReadingOrderModel as JRModel
from marie_tpu_torch.components.word_tokenizer import RollingWordTokenizer
from marie_tpu_torch.models import configs as tcfg
from marie_tpu_torch.models.reading_order import ReadingOrderConfig
from marie_tpu_torch.registry.checkpoints import load_params
from marie_tpu_torch.registry.convert import build_model, from_flax, to_flax
from marie_tpu_torch.train import optim
from marie_tpu_torch.train.loop import init_module
from tests.test_torch_train import PARAM_ATOL, _invariant, _leaves

STEPS, BATCH, DATASET = 5, 4, 48


def _jax_indices(seed):
    """The JAX layout trainers' batch indices (their first block of 5)."""
    _, sub = jax.random.split(jax.random.PRNGKey(seed + 1))
    return [np.asarray(jax.random.randint(k, (BATCH,), 0, DATASET))
            for k in jax.random.split(sub, STEPS)]


def _lr_sum(peak, warmup, decay, steps, end=0.0):
    sched = optim.warmup_cosine_decay_schedule(0.0, peak, warmup, decay, end)
    return sum(float(sched(i)) for i in range(steps))


def _check_params(jparams, tparams, init, lr_sum, reading_order=False):
    want, got, start = _leaves(jparams), _leaves(tparams), _leaves(init)
    assert set(want) <= set(got)
    for path, w in want.items():
        if _invariant(path, reading_order):
            # moved by Adam on rounding noise: at most 3 lr a step on each side
            assert np.abs(got[path] - w).max() <= 2 * 3 * lr_sum, path
            continue
        assert np.abs(got[path] - w).max() <= PARAM_ATOL, path
    assert any(np.abs(want[p] - start[p]).max() > 5 * PARAM_ATOL for p in want)  # it trained


@pytest.mark.parametrize("trainer,head,options", [
    ("train_layout_splitter", "sequence", {}),
    ("train_layout_classifier", "sequence", {}),
    ("train_layout_indexer", "token", {}),
    # the chained heads' options (scripts/train_chain_heads.py)
    ("train_layout_classifier", "sequence", {"shuffle_words": True, "rolling": True}),
    ("train_layout_indexer", "token", {"shuffle_words": True, "rolling": True}),
])
def test_layout_trainer_five_steps_match_jax(trainer, head, options):
    options = dict(options)
    seed = 3
    labels = {"train_layout_splitter": 2, "train_layout_classifier": 3,
              "train_layout_indexer": 5}[trainer]
    cfg_j, cfg_t = jcfg.LayoutLMConfig.tiny(labels), tcfg.LayoutLMConfig.tiny(labels)
    jkw, tkw = {}, {}
    if options.pop("rolling", False):
        jkw["tokenizer"], tkw["tokenizer"] = JRolling(cfg_j.vocab_size), RollingWordTokenizer(
            cfg_t.vocab_size)
    common = dict(steps=STEPS, batch_size=BATCH, dataset_size=DATASET, steps_per_dispatch=STEPS,
                  seed=seed, **options)
    _, jparams, jmetric, _ = getattr(JL, trainer)(config=cfg_j, **common, **jkw)
    l = cfg_j.max_seq_len
    init = (JSeq if head == "sequence" else JTok)(cfg_j).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, l), jnp.int32), jnp.zeros((1, l, 4), jnp.int32),
        jnp.ones((1,), jnp.int32), None)
    timing = {}
    model, tparams, tmetric, _ = getattr(TL, trainer)(
        config=cfg_t, **common, **tkw, device="cpu", init_params=jax.device_get(init),
        batch_indices=_jax_indices(seed), timing=timing)
    assert tmetric == jmetric
    assert timing["steps"] == STEPS
    _check_params(jparams, tparams, init, _lr_sum(3e-4, 1, STEPS, STEPS))
    back = to_flax(from_flax(tparams, build_model(cfg_t, head)))
    for path, v in _leaves(tparams).items():
        np.testing.assert_array_equal(_leaves(back)[path], v)


def test_reading_order_trainer_five_steps_match_jax(tmp_path):
    seed = 5
    _, jparams, jacc, jtau = JR.train_reading_order(steps=STEPS, batch_size=BATCH,
                                                    config=JRConfig.tiny(), seed=seed,
                                                    log_every=0)
    boxes0, _, n0 = JR.make_batch(np.random.default_rng(seed), BATCH, 256)
    init = JRModel(JRConfig.tiny()).init(jax.random.PRNGKey(seed), jnp.asarray(boxes0),
                                         jnp.asarray(n0))
    path = str(tmp_path / "ro.npz")
    model, tparams, tacc, ttau = TR.train_reading_order(
        steps=STEPS, batch_size=BATCH, config=ReadingOrderConfig.tiny(), seed=seed, log_every=0,
        device="cpu", init_params=jax.device_get(init), checkpoint_path=path)
    assert abs(tacc - jacc) <= 1e-6
    assert abs(ttau - jtau) <= 1e-3  # orders of 64 pages; a near tie may swap
    _check_params(jparams, tparams, init, _lr_sum(3e-4, 1, STEPS - 1, STEPS, 1.5e-5),
                  reading_order=True)
    for key, v in _leaves(load_params(path)).items():
        np.testing.assert_array_equal(v, _leaves(tparams)[key])


def test_reading_order_device_trainer_runs_on_the_cpu():
    """The device-resident loop at a tiny size: pool, draws, steps, eval."""
    timing = {}
    model, params, acc, tau = TR.train_reading_order_device(
        steps=4, batch_size=3, pool_pages=8, steps_per_dispatch=2,
        config=ReadingOrderConfig.tiny(), seed=2, device="cpu", timing=timing)
    assert timing["steps"] == 4 and 0.0 <= acc <= 1.0 and -1.0 <= tau <= 1.0
    start = _leaves(to_flax(init_module(ReadingOrderConfig.tiny(), None, 2, device="cpu")))
    got = _leaves(params)
    assert set(got) == set(start)
    assert all(np.isfinite(v).all() for v in got.values())
    assert any(not np.array_equal(got[k], start[k]) for k in got)
