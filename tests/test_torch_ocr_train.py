"""The OCR trainers of the port (``marie_tpu_torch/train/recognizer.py``,
``crnn.py``, ``craft.py``) against the JAX package's on the CPU, at tiny
widths.

* ``SyntheticWordDataset``: the same seed gives the same texts and tokens,
  and images equal to the bit (limits: max 0, mean 0) with the recipe's
  augmentations on; ``render_page_with_targets``: the same pages and
  targets (IoU 1 >= 0.98).
* ``character_error_rate`` equal on a hypothesis strategy; the CTC loss
  against ``optax.ctc_loss``, an alignment that cannot be made included.
* Five steps of each device trainer from the JAX trainer's starting tree
  on the batches JAX's ``jax.random`` keys draw (indices and noise,
  computed here as ``tests/test_torch_train_steps.py::_jax_indices``
  does): the loss within 1e-5 relative at each step (JAX's read through
  ``jax.debug.callback``), the trained tree as ``_check_params`` holds it
  (1e-4; the leaves the loss does not depend on to Adam's bound) and the
  held-out CER equal.  CRAFT's BatchNorm trains on batch statistics with
  flax's fast variance, which is ill-conditioned at these shapes: JAX's
  own float32 gradient departs from its float64 gradient by up to ~12%
  of a leaf's largest (stage4 kernels).  So CRAFT's five steps are held
  in float64, against the JAX step replayed in float64 (1e-10 loss,
  parameters and running statistics), its one step against JAX's
  gradients in float64 (1e-9 loss, 1e-7 gradients and running
  statistics), and the float32 trainer against JAX's own trainer at the
  loss before the first update and at Adam's bound after it.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp
import optax

import marie_tpu.train.craft as JCR
import marie_tpu.train.crnn as JRN
import marie_tpu.train.recognizer as JR
import marie_tpu_torch.train.craft as TCR
import marie_tpu_torch.train.crnn as TRN
import marie_tpu_torch.train.recognizer as TR
from marie_tpu.models import configs as jcfg
from marie_tpu.models.craft import CRAFT as JCRAFT
from marie_tpu.models.crnn import CRNN as JCRNN
from marie_tpu.models.trocr import TrOCRModel as JTrOCR
from marie_tpu_torch.models import configs as tcfg
from marie_tpu_torch.registry.convert import build_model, from_flax, to_flax
from marie_tpu_torch.train import batchnorm, optim
from marie_tpu_torch.train.loop import init_module
from marie_tpu_torch.utils.device import float32_precision
from tests.test_torch_train import PARAM_ATOL, _leaves

STEPS = 5
LOSS_RTOL = 1e-5
#: the recognizer recipe (scripts/round4_chain4.sh)
RECIPE = dict(rotate_deg=2, text_mode="open", font_sizes=(14, 18, 20, 24, 30), bold_p=0.35,
              shear_p=0.15)
CRAFT_CFG = dict(base_channels=8, stem_stride=2, head_d2s=True)  # fast_s2d2 at 1/4 width
CRAFT_HW = (256, 192)
CRAFT_HW_F64 = (128, 96)  # the float64 step: XLA's float64 convolutions are slow on the CPU


# ------------------------------------------------------------------ the data
@pytest.mark.parametrize("name,kwargs", [
    ("recipe", dict(config="fast_v3_g2_d6", noise=0.03, **RECIPE)),
    ("lexicon_dither", dict(config="tiny", noise=0.03, dither_p=0.5, bold_p=0.5)),
    ("crnn", dict(config="crnn", noise=0.0)),
])
def test_synthetic_word_dataset_matches_jax(name, kwargs):
    kwargs = dict(kwargs)
    which = kwargs.pop("config")
    if which == "crnn":
        jc, tc = JRN._crnn_render_config(256, 32), TRN._crnn_render_config(256, 32)
    else:
        jc, tc = getattr(jcfg.TrOCRConfig, which)(), getattr(tcfg.TrOCRConfig, which)()
    ji, jt, jx = JR.SyntheticWordDataset(jc, seed=11, **kwargs).sample(96)
    ti, tt, tx = TR.SyntheticWordDataset(tc, seed=11, **kwargs).sample(96)
    assert tx == jx
    np.testing.assert_array_equal(tt, jt)
    diff = np.abs(ti - ji)
    share = float((diff == 0).mean())
    print(f"{name}: max {diff.max()}, mean {diff.mean()}, equal to the bit {share}")
    assert diff.max() == 0.0 and diff.mean() == 0.0


def _iou(a, b):
    a, b = a > 127, b > 127
    union = (a | b).sum()
    return 1.0 if union == 0 else (a & b).sum() / union


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_render_page_with_targets_matches_jax(seed):
    jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(4):  # dense and sparse layouts, the low-resolution pages
        jp, jt = JCR.render_page_with_targets(jr, out_stride=2)
        tp, tt = TCR.render_page_with_targets(tr, out_stride=2)
        np.testing.assert_array_equal(tp, jp)
        for c in range(2):
            assert _iou(tt[..., c], jt[..., c]) >= 0.98
        np.testing.assert_array_equal(tt, jt)
    assert jr.random() == tr.random()  # the generators end in the same state


# ---------------------------------------------------------------- the losses
@settings(max_examples=200, deadline=None)
@given(st.text(alphabet="ab1 .", max_size=12), st.text(alphabet="ab1 .", max_size=12))
def test_character_error_rate_matches_jax(pred, truth):
    assert TR.character_error_rate(pred, truth) == JR.character_error_rate(pred, truth)


@pytest.mark.parametrize("case", ["alignable", "repeats", "impossible"])
def test_ctc_loss_matches_optax(case):
    rng = np.random.default_rng({"alignable": 0, "repeats": 1, "impossible": 2}[case])
    b, t, v, n = 4, 12, 9, 8
    logits = rng.standard_normal((b, t, v)).astype(np.float32)
    labels = rng.integers(1, v, (b, n)).astype(np.int32)
    lengths = np.array([3, 8, 5, 1], np.int32)
    if case == "repeats":
        labels[:, 1] = labels[:, 0]  # a blank must separate them
    if case == "impossible":
        labels[1] = [4, 4, 4, 4, 4, 4, 4, 4]  # 8 labels need 15 frames > 12
    for i, n_i in enumerate(lengths):
        labels[i, n_i:] = 0
    pad = (np.arange(n)[None, :] >= lengths[:, None]).astype(np.float32)
    want = np.asarray(optax.ctc_loss(jnp.asarray(logits), jnp.zeros((b, t)), jnp.asarray(labels),
                                     jnp.asarray(pad), blank_id=0))
    possible = TRN.alignments_possible(labels, lengths, t)
    assert possible == (case != "impossible")
    got = TRN.ctc_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                       torch.from_numpy(lengths), possible).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    if case == "impossible":
        assert want[1] > 1e4 and np.isfinite(got).all()
        torch_ctc = TRN.ctc_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                 torch.from_numpy(lengths), True).numpy()
        assert np.isinf(torch_ctc[1])  # where F.ctc_loss would not do


def test_adamw_clip_matches_optax():
    rng = np.random.default_rng(4)
    params = {"a": rng.standard_normal((5, 3)).astype(np.float32),
              "b": rng.standard_normal((7,)).astype(np.float32)}
    sched = optax.warmup_cosine_decay_schedule(0.0, 1e-2, 1, 4)
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(sched, weight_decay=0.01))
    state = opt.init(params)
    tp = [torch.from_numpy(params[k].copy()) for k in ("a", "b")]
    tadam = optim.AdamW(tp, optim.warmup_cosine_decay_schedule(0.0, 1e-2, 1, 4),
                        weight_decay=0.01, clip_norm=1.0)
    jp = params
    for scale in (3.0, 0.05, 2.0, 0.5):  # above and below the clip
        grads = {k: (scale * rng.standard_normal(v.shape)).astype(np.float32)
                 for k, v in jp.items()}
        upd, state = opt.update(grads, state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, k in zip(tp, ("a", "b")):
            p.grad = torch.from_numpy(grads[k])
        tadam.step()
        for p, k in zip(tp, ("a", "b")):
            np.testing.assert_allclose(p.numpy(), np.asarray(jp[k]), rtol=0, atol=1e-7)


# ----------------------------------------------------------- the trainers
def _jax_batches(seed, batch, dataset, shape, noise=None, craft=False):
    """The JAX device trainers' first block: each step's indices and the
    noise it adds (``noise *`` a normal, or CRAFT's per-page sigma in
    [0, 0.08) times a normal)."""
    _, sub = jax.random.split(jax.random.PRNGKey(seed + 1))
    idx, added = [], []
    for k in jax.random.split(sub, STEPS):
        if craft:
            k_idx, k_sigma, k_noise = jax.random.split(k, 3)
            sigma = jax.random.uniform(k_sigma, (batch, 1, 1, 1), minval=0.0, maxval=0.08)
            added.append(np.array(sigma * jax.random.normal(k_noise, shape)))
        else:
            k_idx, k_noise = jax.random.split(k)
            added.append(np.array(noise * jax.random.normal(k_noise, shape)))
        idx.append(np.array(jax.random.randint(k_idx, (batch,), 0, dataset)))
    return idx, added


def _recorder(seen):
    def record(v):
        seen.append(np.asarray(v))
    return lambda x: jax.debug.callback(record, x, ordered=True)


def _check_tree(jtree, ttree, init, atol, invariant=lambda path: False, bound=None):
    want, got, start = _leaves(jtree), _leaves(ttree), _leaves(init)
    assert set(want) == set(got)
    for path, w in want.items():
        limit = bound if invariant(path) else atol
        assert np.abs(got[path] - w).max() <= limit, (path, np.abs(got[path] - w).max())
    assert any(np.abs(want[p] - start[p]).max() > 5 * PARAM_ATOL for p in want)  # it trained


def _lr_sum(peak, steps):
    sched = optim.warmup_cosine_decay_schedule(0.0, peak, max(steps // 10, 1), steps)
    return sum(float(sched(i)) for i in range(steps))


def test_recognizer_trainer_five_steps_match_jax(monkeypatch):
    seed, batch, dataset = 3, 4, 16
    kw = dict(steps=STEPS, batch_size=batch, dataset_size=dataset, steps_per_dispatch=STEPS,
              noise=0.03, seed=seed, eval_samples=8, refresh_every=0, **RECIPE)
    seen = []
    rec = _recorder(seen)
    orig = JR.cross_entropy_loss

    def loss_and_record(logits, targets, pad_id):
        loss = orig(logits, targets, pad_id)
        rec(loss)
        return loss

    monkeypatch.setattr(JR, "cross_entropy_loss", loss_and_record)
    cfg = jcfg.TrOCRConfig.tiny()
    _, jparams, jcer = JR.train_recognizer_device(config=cfg, **kw)
    h, w = cfg.encoder.image_size
    init = jax.device_get(jax.jit(JTrOCR(cfg).init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, h, w, 3)),
        jnp.zeros((1, cfg.decoder.max_len - 1), jnp.int32)))
    idx, noise = _jax_batches(seed, batch, dataset, (batch, h, w, 3), noise=0.03)
    losses, timing = [], {}
    model, tparams, tcer = TR.train_recognizer_device(
        config=tcfg.TrOCRConfig.tiny(), **kw, device="cpu", init_params=init, losses=losses,
        timing=timing, batch_indices=idx, batch_noise=noise)
    assert timing["steps"] == STEPS and len(seen) == STEPS
    np.testing.assert_allclose(losses, np.asarray(seen, np.float64), rtol=LOSS_RTOL)
    _check_tree(jparams, tparams, init, PARAM_ATOL,
                lambda p: p[-3:-1] == ("kv", "k") and p[-1] == "bias", 2 * 3 * _lr_sum(3e-4, STEPS))
    assert tcer == jcer
    back = to_flax(from_flax(tparams, build_model(tcfg.TrOCRConfig.tiny())))
    for path, v in _leaves(tparams).items():
        np.testing.assert_array_equal(_leaves(back)[path], v)


def test_recognizer_host_trainer_matches_jax():
    """``train_recognizer``: host batches of the seed's dataset (its init
    batch drawn first, as JAX draws it for ``model.init``), the same steps
    and held-out CER."""
    seed, batch, steps = 6, 4, STEPS
    cfg = jcfg.TrOCRConfig.tiny()
    _, jparams, jcer = JR.train_recognizer(config=cfg, steps=steps, batch_size=batch,
                                           eval_every=0, seed=seed, log_every=100)
    h, w = cfg.encoder.image_size
    init = jax.device_get(jax.jit(JTrOCR(cfg).init)(
        jax.random.PRNGKey(seed), jnp.zeros((batch, h, w, 3)),
        jnp.zeros((batch, cfg.decoder.max_len - 1), jnp.int32)))
    _, tparams, tcer = TR.train_recognizer(config=tcfg.TrOCRConfig.tiny(), steps=steps,
                                           batch_size=batch, eval_every=0, seed=seed,
                                           log_every=100, device="cpu", init_params=init)
    _check_tree(jparams, tparams, init, PARAM_ATOL,
                lambda p: p[-3:-1] == ("kv", "k") and p[-1] == "bias",
                2 * 3 * _lr_sum(3e-4, steps))
    assert tcer == jcer


def test_crnn_trainer_five_steps_match_jax(monkeypatch):
    """The running statistics are stepped as parameters, as the JAX trainer
    (``train=False``) steps every leaf of its variables."""
    seed, batch, dataset, width = 2, 4, 16, 64
    kw = dict(steps=STEPS, batch_size=batch, dataset_size=dataset, steps_per_dispatch=STEPS,
              width=width, refresh_every=0, noise=0.03, seed=seed)
    seen = []
    rec = _recorder(seen)
    orig = optax.ctc_loss

    def ctc_and_record(*args, **kwargs):
        per = orig(*args, **kwargs)
        rec(per.mean())
        return per

    monkeypatch.setattr(optax, "ctc_loss", ctc_and_record)
    cfg = jcfg.CRNNConfig.tiny()
    _, jvars, jcer = JRN.train_crnn_device(config=cfg, **kw)
    monkeypatch.setattr(optax, "ctc_loss", orig)
    h = cfg.input_height
    init = jax.device_get(jax.jit(JCRNN(cfg).init)(jax.random.PRNGKey(seed),
                                                   jnp.zeros((1, h, width, 1))))
    idx, noise = _jax_batches(seed, batch, dataset, (batch, h, width, 1), noise=0.03)
    losses = []
    _, tvars, tcer = TRN.train_crnn_device(
        config=tcfg.CRNNConfig.tiny(), **kw, device="cpu", init_params=init, losses=losses,
        batch_indices=idx, batch_noise=noise)
    assert len(seen) == STEPS
    np.testing.assert_allclose(losses, np.asarray(seen, np.float64), rtol=LOSS_RTOL)
    _check_tree(jvars, tvars, init, PARAM_ATOL)
    moved = [np.abs(_leaves(tvars)[p] - v).max() for p, v in _leaves(init).items()
             if p[0] == "batch_stats"]
    assert max(moved) > 5 * PARAM_ATOL  # the statistics were stepped
    assert tcer == jcer


def _flax_stats_tree(tree):
    return {"params": tree["params"], "batch_stats": tree["batch_stats"]}


def test_craft_step_matches_jax_in_float64():
    """One training step's loss, gradients and new running statistics in
    float64 (flax ``train=True``: batch statistics with the fast variance,
    momentum 0.99 on the biased variance)."""
    cfg_j, cfg_t = jcfg.CraftConfig(**CRAFT_CFG), tcfg.CraftConfig(**CRAFT_CFG)
    rng = np.random.default_rng(5)
    pages, targets = TCR.render_pages(rng, 2, CRAFT_HW_F64, cfg_t.out_stride)
    x = pages.astype(np.float64) / 255.0
    t = targets.astype(np.float64) / 255.0
    model_j = JCRAFT(cfg_j)
    init = jax.device_get(jax.jit(model_j.init)(jax.random.PRNGKey(1),
                                                jnp.zeros((1, *CRAFT_HW_F64, 3))))
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), init)

        def loss_fn(p):
            out, mut = model_j.apply({"params": p, "batch_stats": p64["batch_stats"]},
                                     jnp.asarray(x), train=True, mutable=["batch_stats"])
            tt = jnp.asarray(t)
            return ((1.0 + 9.0 * tt) * (out - tt) ** 2).mean(), mut["batch_stats"]

        (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            p64["params"])
        jloss, jstats, jgrads = float(jloss), jax.device_get(jstats), jax.device_get(jgrads)
    finally:
        jax.config.update("jax_enable_x64", prev)
    model = init_module(cfg_t, None, 0, init, "cpu").double().train()
    batchnorm.use_batch_statistics(model)
    with float32_precision(False):
        loss = TCR.craft_loss(model)(torch.from_numpy(x), torch.from_numpy(t))
    loss.backward()
    assert abs(float(loss.detach()) - jloss) <= 1e-9 * abs(jloss)
    batchnorm.update_running_statistics(model)
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    batchnorm.restore(model)
    stats = _leaves({"batch_stats": to_flax(model)["batch_stats"]})
    for path, v in _leaves({"batch_stats": jstats}).items():
        assert np.abs(stats[path] - v).max() <= 1e-7, path
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(grads[n])
    tg, jg = _leaves({"params": to_flax(model)["params"]}), _leaves({"params": jgrads})
    for path, g in jg.items():
        if _craft_invariant(path):  # rounding noise on both sides
            assert np.abs(tg[path]).max() <= 1e-12 and np.abs(g).max() <= 1e-12
            continue
        assert np.abs(tg[path] - g).max() <= 1e-7 * np.abs(g).max(), path


def _craft_invariant(path):
    """A convolution bias right before a batch-statistics BatchNorm: the
    loss does not depend on it, its gradient is rounding noise."""
    return path[-2:] == ("Conv_0", "bias") and path[1] != "head_out"


def test_craft_trainer_five_steps_match_jax():
    """Five steps of ``train_craft_device`` in float64 against the JAX
    trainer's step (``marie_tpu/train/craft.py::train_craft_device``'s
    ``one_step``: flax ``train=True``, the running statistics from the
    step's batch, clip 1.0, AdamW under warmup + cosine) replayed here in
    float64 on JAX's pages, indices, per-page noise and float32 learning
    rates.  Limits (measured: 4.5e-15, 4.7e-13, 2.3e-11): the loss at
    every step 1e-12 relative, every parameter and running statistic
    1e-11 absolute, the convolution biases the loss does not depend on
    1e-10."""
    seed, batch, dataset, lr = 4, 2, 6, 5e-4
    cfg_j, cfg_t = jcfg.CraftConfig(**CRAFT_CFG), tcfg.CraftConfig(**CRAFT_CFG)
    rng = np.random.default_rng(seed)
    jpages, jtargets = map(np.stack, zip(*(JCR.render_page_with_targets(
        rng, CRAFT_HW_F64, out_stride=cfg_j.out_stride) for _ in range(dataset))))
    idx, noise = _jax_batches(seed, batch, dataset, (batch, *CRAFT_HW_F64, 3), craft=True)
    noise = [n.astype(np.float64) for n in noise]
    model_j = JCRAFT(cfg_j)
    init = jax.device_get(jax.jit(model_j.init)(jax.random.PRNGKey(seed),
                                                jnp.zeros((1, *CRAFT_HW_F64, 3))))
    # the JAX trainer's learning rates are float32 (its count and schedule
    # run in float32): read them here, before float64 is on
    sched = optax.warmup_cosine_decay_schedule(0.0, lr, max(STEPS // 10, 1), STEPS)
    rates = np.asarray([sched(i) for i in range(STEPS)], np.float64)
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), init)
        rates = jnp.asarray(rates)
        sched = lambda count: rates[count]  # noqa: E731
        opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(sched, weight_decay=1e-4))

        @jax.jit
        def one_step(params, stats, opt_state, images, targets):
            def loss_fn(p):
                out, mut = model_j.apply({"params": p, "batch_stats": stats}, images, train=True,
                                         mutable=["batch_stats"])
                return ((1.0 + 9.0 * targets) * (out - targets) ** 2).mean(), mut["batch_stats"]

            (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
            updates, opt_state = opt.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), stats, opt_state, loss

        params, stats = v64["params"], v64["batch_stats"]
        opt_state = opt.init(params)
        want = []
        for i, n in zip(idx, noise):
            images = jnp.clip(jnp.asarray(jpages[i] / 255.0) + n, 0.0, 1.0)
            params, stats, opt_state, loss = one_step(params, stats, opt_state, images,
                                                      jnp.asarray(jtargets[i] / 255.0))
            want.append(float(loss))
        jvars = jax.device_get({"params": params, "batch_stats": stats})
    finally:
        jax.config.update("jax_enable_x64", prev)
    losses = []
    model, _ = TCR.train_craft_device(
        config=cfg_t, steps=STEPS, batch_size=batch, dataset_size=dataset, page_hw=CRAFT_HW_F64,
        learning_rate=lr, steps_per_dispatch=STEPS, refresh_every=0, seed=seed, device="cpu",
        init_params=init, losses=losses, batch_indices=idx, batch_noise=noise,
        dtype=torch.float64)
    tvars = to_flax(model, np.float64)
    np.testing.assert_allclose(losses, want, rtol=1e-12)
    _check_tree(jvars, tvars, init, 1e-11, _craft_invariant, 1e-10)


def test_craft_trainer_float32_first_steps_match_jax(monkeypatch):
    """The float32 trainer against the JAX trainer itself: the loss of the
    two steps before the parameters first move (step 0 runs at lr 0)
    within 1e-5 relative, and the tree after five steps within Adam's
    bound (the float32 batch statistics are ill-conditioned: JAX's own
    float32 gradient departs from its float64 one by up to ~12% of a
    leaf's largest)."""
    seed, batch, dataset = 4, 2, 6
    kw = dict(steps=STEPS, batch_size=batch, dataset_size=dataset, page_hw=CRAFT_HW,
              steps_per_dispatch=STEPS, refresh_every=0, seed=seed)
    outs = []
    rec = _recorder(outs)

    class RecordedCRAFT(JCRAFT):
        def apply(self, variables, *args, **kwargs):
            out = super().apply(variables, *args, **kwargs)
            rec(out[0])
            return out

    monkeypatch.setattr(JCR, "CRAFT", RecordedCRAFT)
    cfg_j, cfg_t = jcfg.CraftConfig(**CRAFT_CFG), tcfg.CraftConfig(**CRAFT_CFG)
    _, jvars = JCR.train_craft_device(config=cfg_j, **kw)
    init = jax.device_get(jax.jit(JCRAFT(cfg_j).init)(jax.random.PRNGKey(seed),
                                                      jnp.zeros((1, *CRAFT_HW, 3))))
    _, targets = TCR.render_pages(np.random.default_rng(seed), dataset, CRAFT_HW, cfg_t.out_stride)
    idx, noise = _jax_batches(seed, batch, dataset, (batch, *CRAFT_HW, 3), craft=True)
    want = []
    for out, i in zip(outs, idx):
        t = targets[i].astype(np.float32) / 255.0
        want.append(float(((1.0 + 9.0 * t) * (out - t) ** 2).astype(np.float64).mean()))
    losses = []
    _, tvars = TCR.train_craft_device(config=cfg_t, **kw, device="cpu", init_params=init,
                                      losses=losses, batch_indices=idx, batch_noise=noise)
    assert len(want) == STEPS
    np.testing.assert_allclose(losses[:2], want[:2], rtol=LOSS_RTOL)
    _check_tree(jvars, tvars, init, 2 * 3 * _lr_sum(5e-4, STEPS))


def test_parallel_then_train_import_in_a_fresh_process():
    """``parallel/train.py`` imports ``train/optim.py``, which runs this
    package's ``__init__``: the trainers must not import ``parallel`` while
    it loads."""
    import subprocess
    import sys

    out = subprocess.run([sys.executable, "-c", "import marie_tpu_torch.parallel\n"
                          "import marie_tpu_torch.train as t\nprint(t.train_recognizer_device.__name__)"],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "train_recognizer_device"
