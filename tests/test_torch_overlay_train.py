"""The overlay GAN trainer of the port (``marie_tpu_torch/train/overlay.py``)
and the Pillow drawing primitives it draws with (``utils/pil_ops.py``)
against the JAX package's trainer and Pillow 12 on the CPU.

* ``draw_line``, ``draw_rectangle`` and ``draw_ellipse`` equal to
  ``ImageDraw`` to the bit: every ellipse of the renderer's range (boxes
  60-119 px wide, 30-59 high, outlines 2 and 3: 3,600 shapes), every rule,
  dash and box it can draw, and a hypothesis sample of each primitive
  outside that range (fills, default inks, clipping, widths to 40).
* ``render_overlay_pair`` equal to JAX's (PIL) to the bit: 16 pairs at
  512x384 from four seeds, and small pages that still draw text, the
  generator's state after each pair too.
* ``PatchDiscriminator`` against flax's forward within DISC_ATOL; its
  4x4 ``"SAME"`` pads; its tree through ``to_flax`` and back.
* Five steps of ``train_overlay_device`` against JAX's at
  ``Pix2PixConfig.tiny()`` on 128x160 pages, from JAX's starting trees on
  the indices JAX's keys draw: each step's three losses within LOSS_RTOL,
  at most PARAM_OFF_SHARE of the generator's elements (the convolution
  biases before a GroupNorm, which the loss does not see, aside) farther
  than PARAM_ATOL from JAX's and every element within Adam's bound; the
  two planted faults (the discriminator and generator stepped in swapped
  order; Adam's b1 at 0.9) each five times outside both limits.
* ``evaluate_overlay`` on the JAX-trained ``pix2pix-synth`` tree against
  JAX's on two pages, within EVAL_LIMIT.
"""

import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image, ImageDraw

import jax
import jax.numpy as jnp

import marie_tpu.train.overlay as JO
import marie_tpu_torch.train.overlay as TO
from marie_tpu.models import configs as jcfg
from marie_tpu.models.pix2pix import ResnetGenerator as JGenerator
from marie_tpu.registry.checkpoints import load_params as jax_load_params
from marie_tpu_torch.models import configs as tcfg
from marie_tpu_torch.models.pix2pix import _same_pads
from marie_tpu_torch.registry.convert import build_model, from_flax, to_flax
from marie_tpu_torch.utils import pil_ops
from tests.test_torch_ocr_train import STEPS, _recorder
from tests.test_torch_train import PARAM_ATOL, _leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DISC_ATOL = 1e-5
LOSS_RTOL = 1e-3  # each step's three losses (1.5e-4 on the CPU; the faults 9e-3 and 0.51)
PARAM_OFF_SHARE = 0.02
PAGE_HW = (128, 160)
SEED, BATCH, DATASET, LR = 4, 2, 4, 2e-4
EVAL_LIMIT = 2e-3  # each held-out figure; they are rounded to 4-5 places


# ------------------------------------------------------- the primitives
def _pil(canvas, draw):
    img = Image.fromarray(canvas.copy())
    draw(ImageDraw.Draw(img))
    return np.asarray(img)


def test_ellipse_equals_pil_over_the_renderers_range():
    """Every stamp the renderer can draw: ``[x0, y0, x0 + a, y0 + b]`` with
    a in 60..119, b in 30..59, outline width 2 or 3, one of its colours."""
    base = np.full((72, 132, 3), 255, np.uint8)
    for a in range(60, 120):
        for b in range(30, 60):
            for width in (2, 3):
                box = [3, 5, 3 + a, 5 + b]
                colour = TO._OVERLAY_COLORS[(a + b + width) % len(TO._OVERLAY_COLORS)]
                want = _pil(base, lambda d: d.ellipse(box, outline=colour, width=width))
                got = pil_ops.draw_ellipse(base.copy(), box, outline=colour, width=width)
                assert np.array_equal(got, want), (a, b, width)


def test_rules_boxes_and_dashes_equal_pil_over_the_renderers_range():
    """Rules across the page at every row and column and width the renderer
    draws (clipped at x = w, y = h), dashes at the page's right edge, and
    outlined and filled boxes of its widths, touching the page's edges."""
    h, w = 40, 48
    base = np.full((h, w, 3), 255, np.uint8)
    colour = TO._OVERLAY_COLORS[3]
    for width in (1, 2, 3):
        for y in range(h):
            xy = [(0, y), (w, y)]
            want = _pil(base, lambda d: d.line(xy, fill=colour, width=width))
            assert np.array_equal(pil_ops.draw_line(base.copy(), xy, colour, width), want)
        for x in range(w):
            xy = [(x, 0), (x, h)]
            want = _pil(base, lambda d: d.line(xy, fill=colour, width=width))
            assert np.array_equal(pil_ops.draw_line(base.copy(), xy, colour, width), want)
    for x in range(w - 4, w):
        xy = [(x, 7), (x + 3, 7)]
        want = _pil(base, lambda d: d.line(xy, fill=colour, width=1))
        assert np.array_equal(pil_ops.draw_line(base.copy(), xy, colour, 1), want)
    for x0, y0, x1, y1 in ((0, 0, w - 1, h - 1), (5, 3, 30, 20), (20, 30, w - 1, h - 1),
                           (1, 1, 4, 3)):
        for width in (1, 2):
            box = [x0, y0, x1, y1]
            want = _pil(base, lambda d: d.rectangle(box, outline=colour, width=width))
            assert np.array_equal(
                pil_ops.draw_rectangle(base.copy(), box, outline=colour, width=width), want)
        want = _pil(base, lambda d: d.rectangle(box, fill=(215, 215, 215)))
        assert np.array_equal(pil_ops.draw_rectangle(base.copy(), box, fill=(215, 215, 215)),
                              want)


_ink = st.one_of(st.none(), st.integers(-300, 1 << 24),
                 st.tuples(*[st.integers(0, 255)] * 3))


@settings(max_examples=300, deadline=None, derandomize=True)
@given(kind=st.sampled_from(["ellipse", "rectangle"]), rgb=st.booleans(),
       x0=st.integers(-30, 60), y0=st.integers(-30, 50), a=st.integers(0, 150),
       b=st.integers(0, 120), width=st.integers(0, 40), fill=_ink, outline=_ink,
       seed=st.integers(0, 2**16))
def test_shapes_equal_pil_outside_the_range(kind, rgb, x0, y0, a, b, width, fill, outline,
                                            seed):
    """Boxes of any size from a point to past the canvas, fills and
    outlines (packed and per-channel inks, Pillow's default ink where both
    are missing), widths to 40, on grey and RGB canvases of noise."""
    if not rgb:
        fill, outline = (v[0] if isinstance(v, tuple) else v for v in (fill, outline))
    shape = (64, 80, 3) if rgb else (64, 80)
    base = np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)
    box = [x0, y0, x0 + a, y0 + b]
    want = _pil(base, lambda d: getattr(d, kind)(box, fill=fill, outline=outline, width=width))
    got = getattr(pil_ops, f"draw_{kind}")(base.copy(), box, fill, outline, width)
    assert np.array_equal(got, want)


@settings(max_examples=300, deadline=None, derandomize=True)
@given(rgb=st.booleans(), vertical=st.booleans(), at=st.integers(-10, 70),
       a=st.integers(-20, 100), b=st.integers(-20, 100), width=st.integers(0, 12),
       fill=_ink.filter(lambda v: v is not None))
def test_lines_equal_pil_outside_the_range(rgb, vertical, at, a, b, width, fill):
    """Horizontal and vertical segments either way round, points, widths
    to 12, clipped at every edge."""
    if not rgb and isinstance(fill, tuple):
        fill = fill[0]
    base = np.full((64, 80, 3) if rgb else (64, 80), 128, np.uint8)
    xy = [(at, a), (at, b)] if vertical else [(a, at), (b, at)]
    want = _pil(base, lambda d: d.line(xy, fill=fill, width=width))
    assert np.array_equal(pil_ops.draw_line(base.copy(), xy, fill, width), want)


def test_slanted_lines_raise():
    with pytest.raises(ValueError, match="horizontal and vertical"):
        pil_ops.draw_line(np.zeros((8, 8), np.uint8), [(0, 0), (5, 3)], 255, 2)


# ------------------------------------------------------------ the renderer
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_render_overlay_pair_equals_jax_at_the_recipes_size(seed):
    """Four pairs a seed at 512x384: clean, dirty and mask to the bit, and
    the generators in step after each pair."""
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(4):
        want = JO.render_overlay_pair(rj, (512, 384))
        got = TO.render_overlay_pair(rt, (512, 384))
        for w, g in zip(want, got):
            assert g.dtype == np.uint8 and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        assert rj.bit_generator.state == rt.bit_generator.state
    assert (want[1] != 255).any(axis=-1).mean() > 0.05  # rules, boxes and text drawn


@pytest.mark.parametrize("hw", [PAGE_HW, (96, 128), (200, 136)])
def test_render_overlay_pair_equals_jax_on_small_pages(hw):
    rj, rt = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(6):
        want = JO.render_overlay_pair(rj, hw)
        got = TO.render_overlay_pair(rt, hw)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)
    assert (np.asarray(want[0]) < 128).any()  # text drawn


def test_text_blends_per_channel_over_colour():
    """The atlas's text over coloured ground as Pillow blends RGB: each
    channel alike."""
    from marie_tpu_torch.utils.glyphs import load_font

    from PIL import ImageFont

    rng = np.random.default_rng(5)
    base = rng.integers(0, 256, (40, 160, 3)).astype(np.uint8)
    pil_font = ImageFont.truetype("/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf", 18)
    for fill in ((0, 0, 0), (200, 30, 90), 0x336699):
        want = _pil(base, lambda d: d.text((7, 9), "invoice 375.20", fill=fill, font=pil_font))
        got = load_font("DejaVuSans", 18).draw_text(base.copy(), (7, 9), "invoice 375.20",
                                                     fill=fill)
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------- the discriminator
def test_same_pads_of_the_4x4_convolutions():
    assert _same_pads(128, 4, 2) == (1, 1)
    assert _same_pads(64, 4, 2) == (1, 1)
    assert _same_pads(16, 4, 1) == (1, 2)
    assert _same_pads(33, 4, 2) == (1, 2)


def _jax_disc_tree(seed, hw):
    disc = JO.PatchDiscriminator()
    return jax.device_get(jax.jit(disc.init)(jax.random.PRNGKey(seed),
                                             jnp.zeros((1, *hw, 6), jnp.float32)))


@pytest.mark.parametrize("hw", [(128, 160), (64, 48)])
def test_patch_discriminator_matches_flax(hw):
    tree = _jax_disc_tree(1, hw)
    x = np.random.default_rng(2).uniform(-1, 1, (2, *hw, 6)).astype(np.float32)
    want = np.asarray(jax.jit(JO.PatchDiscriminator().apply)(tree, x))
    model = from_flax(tree, build_model(tcfg.PatchDiscriminatorConfig()))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, hw[0] // 8, hw[1] // 8, 1)
    print("discriminator", np.abs(got - want).max())
    assert np.abs(got - want).max() <= DISC_ATOL
    back = to_flax(model)
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(tree),
                                jax.tree_util.tree_leaves_with_path(back)):
        assert pa == pb
        np.testing.assert_array_equal(a, b)


def test_discriminator_layout_in_the_bridge():
    """``init_flax_layout`` and ``init_flax_defaults`` draw flax's tree
    (names and shapes) for the discriminator's config."""
    from marie_tpu_torch.registry.convert import init_flax_defaults, init_flax_layout

    want = jax.tree_util.tree_map(np.shape, _jax_disc_tree(0, (64, 48)))
    for init in (init_flax_layout, init_flax_defaults):
        got = jax.tree_util.tree_map(np.shape, init(tcfg.PatchDiscriminatorConfig(), 3))
        assert got == want


# ---------------------------------------------------------- the trainer
def _jax_draws(seed):
    """The JAX trainer's first dispatch: each step's batch indices."""
    _, sub = jax.random.split(jax.random.PRNGKey(seed + 2))
    return [np.array(jax.random.randint(k, (BATCH,), 0, DATASET))
            for k in jax.random.split(sub, STEPS)]


@pytest.fixture(scope="module")
def jax_run():
    """The JAX trainer's five steps at ``Pix2PixConfig.tiny()`` (each
    step's discriminator loss and (generator loss, L1) recorded), its
    starting trees, shared by the tests of this file."""
    seen = []
    rec = _recorder(seen)
    orig = jax.value_and_grad

    def value_and_grad(fn, *args, **kwargs):
        def recorded(*a, **kw):
            out = fn(*a, **kw)
            rec(out)
            return out

        return orig(recorded, *args, **kwargs)

    jax.value_and_grad = value_and_grad
    try:
        cfg = jcfg.Pix2PixConfig.tiny()
        gen, jparams, jmetrics = JO.train_overlay_device(
            config=cfg, steps=STEPS, batch_size=BATCH, dataset_size=DATASET, page_hw=PAGE_HW,
            learning_rate=LR, steps_per_dispatch=STEPS, refresh_every=0, seed=SEED)
    finally:
        jax.value_and_grad = orig
    g_init = jax.device_get(jax.jit(JGenerator(cfg).init)(
        jax.random.PRNGKey(SEED), jnp.zeros((1, *PAGE_HW, 3), jnp.float32)))
    d_init = _jax_disc_tree(SEED + 1, PAGE_HW)
    d_losses = [float(v) for v in seen[0::2]]
    g_losses = [tuple(float(u) for u in v) for v in seen[1::2]]
    want = [(d, g, l1) for d, (g, l1) in zip(d_losses, g_losses)]
    return dict(losses=want, jparams=jax.device_get(jparams), jmetrics=jmetrics,
                init=(g_init, d_init))


def _conv_bias_before_norm(path):
    """A generator convolution's bias before its instance norm: the loss
    does not depend on it (every convolution but the last, ``Conv_3``)."""
    return path[-1] == "bias" and path[-2] != "Conv_3" and path[-2].startswith(
        ("Conv_", "ConvTranspose_"))


#: Adam moves an element by up to about lr a step: two runs part by at most
ADAM_BOUND = 2 * STEPS * LR * 1.01


def _port_run(r, **kw):
    losses = []
    _, tvars, metrics = TO.train_overlay_device(
        config=tcfg.Pix2PixConfig.tiny(), steps=STEPS, batch_size=BATCH, dataset_size=DATASET,
        page_hw=PAGE_HW, learning_rate=LR, steps_per_dispatch=STEPS, refresh_every=0,
        seed=SEED, device="cpu", init_params=r["init"], draws=_jax_draws(SEED),
        losses=losses, **kw)
    return np.asarray(losses), tvars, metrics


def _off(r, losses, tvars):
    """(the largest relative loss departure, the share of the generator's
    elements, the invariant biases aside, farther than PARAM_ATOL from
    JAX's, the largest departure of any element)."""
    want = np.asarray(r["losses"])
    loss_err = float((np.abs(losses - want) / np.abs(want)).max())
    w, g = _leaves(r["jparams"]), _leaves(tvars)
    off = [np.abs(g[p] - w[p]) for p in w if not _conv_bias_before_norm(p)]
    share = sum(int((d > PARAM_ATOL).sum()) for d in off) / sum(d.size for d in off)
    return loss_err, share, max(float(np.abs(g[p] - w[p]).max()) for p in w)


def test_overlay_trainer_five_steps_match_jax(jax_run):
    """Adam's first steps move an element by about lr whatever its
    gradient's size, so where a gradient component is below what float32
    resolves the two trainers step it apart by up to 2 lr a step: the
    elements farther than PARAM_ATOL are counted (0.56% on the CPU,
    PARAM_OFF_SHARE allowed; the faults below move 16% and 41%), and every
    element is held to that bound."""
    r = jax_run
    timing = {}
    losses, tvars, _ = _port_run(r, timing=timing)
    print("losses", losses.tolist(), r["losses"])
    assert losses.shape == (STEPS, 3) and timing["steps"] == STEPS
    loss_err, share, worst = _off(r, losses, tvars)
    print("departures", loss_err, share, worst)
    assert loss_err <= LOSS_RTOL and share <= PARAM_OFF_SHARE and worst <= ADAM_BOUND
    w, start = _leaves(r["jparams"]), _leaves(r["init"][0])
    assert any(np.abs(w[p] - start[p]).max() > 5 * PARAM_ATOL for p in w)  # it trained


def _swapped_step(self, x, y, grads=None):
    """The planted fault: the generator stepped first, against the
    discriminator before its step."""
    with TO.float32_precision(False):
        fake = self.gen(x)
        g_loss, l1 = self.g_loss(x, y, fake)
        self._apply(self.g_opt, self.g_params, torch.autograd.grad(g_loss, self.g_params))
        d_loss = self.d_loss(x, y, fake.detach())
        self._apply(self.d_opt, self.d_params, torch.autograd.grad(d_loss, self.d_params))
    return d_loss.detach(), g_loss.detach(), l1.detach()


class _AdamB1(TO.AdamW):
    def __init__(self, params, schedule, **kw):
        kw["b1"] = 0.9
        super().__init__(params, schedule, **kw)


@pytest.mark.parametrize("fault", ["swapped_order", "b1_0.9"])
def test_planted_faults_break_the_five_step_tolerance(jax_run, monkeypatch, fault):
    if fault == "swapped_order":
        monkeypatch.setattr(TO.OverlayGan, "step", _swapped_step)
    else:
        monkeypatch.setattr(TO, "AdamW", _AdamB1)
    losses, tvars, _ = _port_run(jax_run)
    loss_err, share, _ = _off(jax_run, losses, tvars)
    print(fault, loss_err, share)
    assert loss_err > 5 * LOSS_RTOL and share > 5 * PARAM_OFF_SHARE


def test_evaluate_overlay_matches_jax_on_the_zoo_tree():
    """The JAX-trained ``pix2pix-synth`` generator's held-out figures on
    two 512x384 pages, the port's against JAX's."""
    tree = jax.device_get(jax_load_params(os.path.join(REPO, "model_zoo", "pix2pix-synth")))
    want = JO.evaluate_overlay(JGenerator(jcfg.Pix2PixConfig.synth()), tree, (512, 384),
                               n_pages=2, seed=9999)
    gen = build_model(tcfg.Pix2PixConfig.synth())
    got = TO.evaluate_overlay(gen, tree, (512, 384), n_pages=2, seed=9999)
    print(got, want)
    assert set(got) == set(want)
    for key in want:
        assert abs(got[key] - want[key]) <= EVAL_LIMIT, key
    assert got["mask_f1"] > 0.5  # a trained tree


def test_trained_tree_loads_into_the_overlay_processor(tmp_path):
    """The trainer's written tree reads back through ``registry/
    checkpoints.py`` into ``OverlayProcessor``, whose float32 generator
    gives the trainer's held-out figures again."""
    from marie_tpu_torch.overlay.overlay import OverlayProcessor
    from marie_tpu_torch.registry.checkpoints import load_params

    path = str(tmp_path / "pix2pix-tiny.npz")
    gen, tvars, metrics = TO.train_overlay_device(
        config=tcfg.Pix2PixConfig.tiny(), steps=2, batch_size=BATCH, dataset_size=DATASET,
        page_hw=PAGE_HW, steps_per_dispatch=2, refresh_every=0, seed=SEED, device="cpu",
        checkpoint_path=path)
    tree = load_params(path)
    proc = OverlayProcessor(config=tcfg.Pix2PixConfig.tiny(), variables=tree, device="cpu")
    again = TO.evaluate_overlay(proc.models["float32"], None, PAGE_HW, seed=SEED + 9999)
    assert again == metrics
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(tvars),
                                jax.tree_util.tree_leaves_with_path(tree)):
        assert pa == pb
        np.testing.assert_array_equal(a, b)
