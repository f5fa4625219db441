"""The boundary, DiT and TextFuseNet trainers of the port
(``marie_tpu_torch/train/boundary.py``, ``dit.py``, ``textfusenet.py``)
against the JAX package's on the CPU, at tiny widths.

* The batched scan compositor against ``composite_scan`` page by page
  (equal to the bit on the same homographies; within one grey level off
  the quads' edges on its own batched solve: a pixel centre on an edge is
  inside or out by the solver's last bit) and against JAX's ``_make_scan``
  on the same quads and noise (equal to the bit on JAX's homographies,
  within one grey level off the edges on its own).  The trainer's tests
  give the compositor JAX's homographies (``_jax_solve``), so both
  trainers see the same scans.
* The renderers: ``render_page_tfn`` and DiT's ``render_block`` (its cv2
  ``INTER_AREA`` half included) equal to JAX's to the bit.
* Five steps of each trainer from the JAX trainer's starting tree on the
  draws JAX's ``jax.random`` keys make (computed here: indices, quads,
  backgrounds and noise; jitter and shifts): the loss within LOSS_RTOL
  relative at each step (JAX's read through ``jax.debug.callback``), the
  trained tree as ``tests/test_torch_ocr_train.py::_check_tree`` holds it
  (1e-4; the leaves the loss does not depend on to Adam's bound; the
  TextFuseNet's running statistics among the leaves).
* ``evaluate_boundary`` against JAX's on the same scans.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import marie_tpu.train.boundary as JB
import marie_tpu.train.craft as JCR
import marie_tpu_torch.train.boundary as TB
from marie_tpu.models import configs as jcfg
from marie_tpu.models.boundary import BoundaryNet as JBoundaryNet
from marie_tpu.models.boundary import homography_from_points as jax_homography
from marie_tpu_torch.models import boundary as tmb
from marie_tpu_torch.models import configs as tcfg
from marie_tpu_torch.registry.convert import build_model, from_flax
from tests.test_torch_ocr_train import STEPS, _check_tree, _lr_sum, _recorder
from tests.test_torch_train import PARAM_ATOL, _leaves

LOSS_RTOL = 1e-5
BOUNDARY_HW = (48, 64)  # BoundaryConfig.tiny()
EVAL_LIMITS = {"corner_mae_px": 0.01, "corner_p95_px": 0.1, "mean_quad_iou": 1e-3}


# ------------------------------------------------------- the scan compositor
def _jax_scan_draws(keys, hw):
    """JAX's quads, backgrounds and noise of ``_make_scan`` for each key."""

    def draw(k):
        kq, kn = jax.random.split(k)
        quad, bg = JB._sample_quad(kq, hw)
        return quad, bg, jax.random.uniform(kn, hw, minval=-18.0, maxval=18.0)

    return [np.asarray(a) for a in jax.jit(jax.vmap(draw))(keys)]


def _jax_solve(src, dst):
    """JAX's homographies (XLA's 8x8 solve) in place of the port's batched
    solve."""
    h = jax.jit(jax.vmap(jax_homography))(jnp.asarray(src.numpy()), jnp.asarray(dst.numpy()))
    return torch.from_numpy(np.asarray(h))


@pytest.fixture
def jax_solve(monkeypatch):
    monkeypatch.setattr(tmb, "homographies_from_points", _jax_solve)


def _edge_pixels(quads, hw, width=1.5):
    """[B, H, W] True within ``width`` px of a quad's edge."""
    h, w = hw
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    out = np.zeros((len(quads), h, w), bool)
    for b, q in enumerate(quads.astype(np.float64)):
        for i in range(4):
            (ax, ay), (bx, by) = q[i], q[(i + 1) % 4]
            dx, dy = bx - ax, by - ay
            t = np.clip(((xs - ax) * dx + (ys - ay) * dy) / (dx * dx + dy * dy), 0, 1)
            out[b] |= np.hypot(xs - ax - t * dx, ys - ay - t * dy) <= width
    return out


@pytest.mark.parametrize("hw", [BOUNDARY_HW, (192, 256)])
def test_composite_scans_match_composite_scan_and_jax(hw):
    docs = TB.render_docs(3, 4, hw)
    keys = jax.random.split(jax.random.PRNGKey(5), 4)
    quads, bg, noise = _jax_scan_draws(keys, hw)
    args = (torch.from_numpy(docs), torch.from_numpy(quads), hw, torch.from_numpy(bg),
            torch.from_numpy(noise))
    got = tmb.composite_scans(*args).numpy().astype(int)
    # page by page on the host's homographies: the same per-pixel work
    rect = np.asarray([[0, 0], [hw[1] - 1, 0], [hw[1] - 1, hw[0] - 1], [0, hw[0] - 1]],
                      np.float32)
    host_h = torch.from_numpy(np.stack([tmb.homography_from_points(q, rect) for q in quads]))
    batched_solve = tmb.homographies_from_points
    try:
        tmb.homographies_from_points = lambda src, dst: host_h
        same_h = tmb.composite_scans(*args).numpy()
    finally:
        tmb.homographies_from_points = batched_solve
    for i in range(len(docs)):
        one = tmb.composite_scan(docs[i], quads[i], hw, bg[i], noise[i], device="cpu").numpy()
        np.testing.assert_array_equal(same_h[i], one)
    off_edge = ~_edge_pixels(quads, hw)[..., None].repeat(3, -1)
    host = same_h.astype(int)
    diff = np.abs(got - host)
    print(hw, "batched solve vs host solve:", diff.max(), (diff > 0).mean(),
          diff[off_edge].max())
    assert diff[off_edge].max() <= 1
    # JAX's own scans of those keys
    scans, jquads = jax.jit(jax.vmap(lambda k, d: JB._make_scan(k, d, hw)))(keys,
                                                                           jnp.asarray(docs))
    np.testing.assert_array_equal(np.asarray(jquads), quads)
    diff = np.abs(got - np.asarray(scans))
    print(hw, "vs JAX:", diff.max(), (diff > 0).mean(), diff[off_edge].max(),
          (diff[off_edge] > 0).mean())
    assert diff[off_edge].max() <= 1 and (diff[off_edge] > 0).mean() <= 0.1
    try:
        tmb.homographies_from_points = _jax_solve
        np.testing.assert_array_equal(tmb.composite_scans(*args).numpy(), np.asarray(scans))
    finally:
        tmb.homographies_from_points = batched_solve


# ------------------------------------------------------------ the boundary
def _boundary_jax_draws(seed, batch, dataset, hw):
    """The JAX trainer's first block: each step's indices and the quads,
    backgrounds and noise of its scans."""
    _, sub = jax.random.split(jax.random.PRNGKey(seed + 1))
    idx, quads, noise = [], [], []
    for k in jax.random.split(sub, STEPS):
        ki, kg = jax.random.split(k)
        idx.append(np.array(jax.random.randint(ki, (batch,), 0, dataset)))
        q, bg, n = _jax_scan_draws(jax.random.split(kg, batch), hw)
        quads.append((q, bg))
        noise.append(n)
    return idx, quads, noise


def _conv_bias(path):
    """A convolution bias before a per-channel GroupNorm: the loss does
    not depend on it."""
    return path[-1] == "bias" and path[-2].startswith("Conv_")


@pytest.fixture(scope="module")
def boundary_run():
    """The JAX trainer's five steps (each step's predictions recorded),
    shared by the tests of this file."""
    seed, batch, dataset = 2, 4, 8
    outs = []
    rec = _recorder(outs)

    class RecordedBoundaryNet(JBoundaryNet):
        def apply(self, variables, *args, **kwargs):
            out = super().apply(variables, *args, **kwargs)
            rec(out)
            return out

    orig = JB.BoundaryNet
    JB.BoundaryNet = RecordedBoundaryNet
    try:
        cfg = jcfg.BoundaryConfig.tiny()
        _, jparams, jmetrics = JB.train_boundary_device(
            config=cfg, steps=STEPS, batch_size=batch, dataset_size=dataset,
            steps_per_dispatch=STEPS, seed=seed)
    finally:
        JB.BoundaryNet = orig
    init = jax.device_get(jax.jit(JBoundaryNet(cfg).init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, *cfg.input_hw, 3), jnp.float32)))
    return dict(seed=seed, batch=batch, dataset=dataset, outs=outs[:STEPS],
                jparams=jax.device_get(jparams), jmetrics=jmetrics, init=init)


def test_boundary_trainer_five_steps_match_jax(boundary_run, jax_solve):
    r = boundary_run
    cfg = tcfg.BoundaryConfig.tiny()
    hw = cfg.input_hw
    idx, quads, noise = _boundary_jax_draws(r["seed"], r["batch"], r["dataset"], hw)
    norm = np.asarray([hw[1] - 1.0, hw[0] - 1.0], np.float32)
    want = [float(((out - (q / norm).reshape(len(q), 8)) ** 2).astype(np.float64).mean())
            for out, (q, _) in zip(r["outs"], quads)]
    losses = []
    _, tvars, _ = TB.train_boundary_device(
        config=cfg, steps=STEPS, batch_size=r["batch"], dataset_size=r["dataset"],
        steps_per_dispatch=STEPS, seed=r["seed"], device="cpu", init_params=r["init"],
        losses=losses, batch_indices=idx, batch_quads=quads, batch_noise=noise)
    print("losses", losses, want)
    np.testing.assert_allclose(losses, want, rtol=LOSS_RTOL)
    _check_tree(r["jparams"], tvars, r["init"], PARAM_ATOL, _conv_bias,
                2 * 3 * _lr_sum(4e-4, STEPS))


def test_evaluate_boundary_matches_jax(boundary_run, jax_solve):
    """The JAX-trained tree's held-out figures, the port's on JAX's quads
    and noise: the solve inside JAX's compiled scan rounds a few edge
    pixels otherwise (``_jax_solve`` is a separate program), which moves
    the untrained tree's corners by up to ~0.2 px: EVAL_LIMITS."""
    r = boundary_run
    cfg_j, cfg_t = jcfg.BoundaryConfig.tiny(), tcfg.BoundaryConfig.tiny()
    n_pages, seed = 16, 31
    want = JB.evaluate_boundary(JBoundaryNet(cfg_j), r["jparams"], cfg_j, n_pages=n_pages,
                                seed=seed)
    quads, bg, noise = _jax_scan_draws(jax.random.split(jax.random.PRNGKey(seed), n_pages),
                                       cfg_t.input_hw)
    model = from_flax(r["jparams"], build_model(cfg_t))
    got = TB.evaluate_boundary(model, cfg_t, n_pages=n_pages, seed=seed, quads=(quads, bg),
                               noise=noise)
    print(got, want)
    assert set(got) == set(want)
    for key, limit in EVAL_LIMITS.items():
        assert abs(got[key] - want[key]) <= limit, key


def _record_losses(monkeypatch, seen):
    """Every ``jax.value_and_grad`` of the run reports its loss to ``seen``
    (``jax.debug.callback``: once a step inside ``lax.scan``)."""
    rec = _recorder(seen)
    orig = jax.value_and_grad

    def value_and_grad(fn, *args, **kwargs):
        def recorded(*a, **kw):
            out = fn(*a, **kw)
            rec(out)
            return out

        return orig(recorded, *args, **kwargs)

    monkeypatch.setattr(jax, "value_and_grad", value_and_grad)


def _step_keys(seed):
    """The JAX trainers' first block: one key a step."""
    _, sub = jax.random.split(jax.random.PRNGKey(seed + 1))
    return jax.random.split(sub, STEPS)


# ------------------------------------------------------------------ DiT
TINY_DIT = dict(image_size=(128, 96), patch_size=16, hidden_dim=64, num_layers=2, num_heads=2,
                mlp_dim=128, use_cls_token=False, head_stride=1, subpixel=2)


def _jax_render_block(block_seed, n, page_hw, head_stride):
    """The JAX trainer's ``render_block`` (a closure of ``train_dit_device``):
    its renderer and cv2's ``INTER_AREA``, at its default sizes."""
    import cv2

    rng = np.random.default_rng(block_seed)
    h, w = page_hw
    pages, targets = [], []
    for i in range(n):
        if i % 2 == 0:
            p2, t = JCR.render_page_with_targets(rng, (h * 2, w * 2),
                                                 font_sizes=(14, 18, 20, 24, 28),
                                                 out_stride=head_stride * 2)
            p = cv2.resize(p2, (w, h), interpolation=cv2.INTER_AREA)
        else:
            p, t = JCR.render_page_with_targets(rng, page_hw, font_sizes=(7, 9, 11, 13, 18, 22),
                                                out_stride=head_stride)
        pages.append(p)
        targets.append(t)
    return np.stack(pages), np.stack(targets)


@pytest.mark.parametrize("page_hw,head_stride", [((512, 384), 1), ((512, 384), 2),
                                                 ((128, 96), 1)])
def test_dit_render_block_matches_jax(page_hw, head_stride):
    import marie_tpu_torch.train.dit as TD

    want = _jax_render_block(7, 6, page_hw, head_stride)
    got = TD.render_block(7, 6, page_hw, head_stride)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_dit_trainer_five_steps_match_jax(monkeypatch):
    """The encoder's attention is the plain version of K2 here (CPU
    tensors) and its autograd gradient."""
    import marie_tpu.train.dit as JD
    import marie_tpu_torch.train.dit as TD
    from marie_tpu.boxes.dit_box_processor import DiTDetector

    seed, batch, dataset = 1, 2, 6
    kw = dict(steps=STEPS, batch_size=batch, dataset_size=dataset, steps_per_dispatch=STEPS,
              refresh_every=0, seed=seed)
    seen = []
    _record_losses(monkeypatch, seen)
    cfg_j = jcfg.ViTConfig(**TINY_DIT)
    _, jparams = JD.train_dit_device(config=cfg_j, **kw)
    monkeypatch.undo()
    init = jax.device_get(jax.jit(DiTDetector(cfg_j).init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, *cfg_j.image_size, 3), jnp.float32)))
    idx = [np.array(jax.random.randint(k, (batch,), 0, dataset)) for k in _step_keys(seed)]
    losses, timing = [], {}
    _, tvars = TD.train_dit_device(config=tcfg.ViTConfig(**TINY_DIT), **kw, device="cpu",
                                   init_params=init, losses=losses, timing=timing,
                                   batch_indices=idx)
    assert len(seen) == STEPS and timing["steps"] == STEPS and timing["pages_per_s"] > 0
    np.testing.assert_allclose(losses, np.asarray(seen, np.float64), rtol=LOSS_RTOL)
    _check_tree(jax.device_get(jparams), tvars, init, PARAM_ATOL,
                lambda p: p[-3:-1] == ("kv", "k") and p[-1] == "bias",
                2 * 3 * _lr_sum(3e-4, STEPS))


# ---------------------------------------------------------- TextFuseNet
TINY_TFN = dict(max_words=8, max_chars=16, channels=16, backbone_widths=(8, 16, 32),
                head_stride=2)  # tests/unit/test_textfusenet.py's, with the s2 head
TFN_HW = (192, 160)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_render_page_tfn_matches_jax(seed):
    import marie_tpu.train.textfusenet as JT
    import marie_tpu_torch.train.textfusenet as TT

    jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(3):
        want = JT.render_page_tfn(jr)
        got = TT.render_page_tfn(tr)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    got = TT.render_page_tfn(tr, TFN_HW, max_words=8, max_chars=16)
    want = JT.render_page_tfn(jr, TFN_HW, max_words=8, max_chars=16)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert jr.random() == tr.random()


def test_textfusenet_trainer_five_steps_match_jax(monkeypatch):
    """``train=False`` with every leaf stepped: the running statistics are
    held with the parameters and must have moved."""
    import marie_tpu.train.textfusenet as JT
    import marie_tpu_torch.train.textfusenet as TT
    from marie_tpu.models.textfusenet import TextFuseNet as JTextFuseNet
    from marie_tpu.models.textfusenet import TextFuseNetConfig as JTextFuseNetConfig

    seed, batch, dataset = 3, 2, 4
    kw = dict(steps=STEPS, batch_size=batch, dataset_size=dataset, page_hw=TFN_HW,
              steps_per_dispatch=STEPS, seed=seed)
    seen = []
    _record_losses(monkeypatch, seen)
    cfg_j = JTextFuseNetConfig(**TINY_TFN)
    jvars = JT.train_textfusenet_device(config=cfg_j, **kw)
    monkeypatch.undo()
    init = jax.device_get(jax.jit(lambda k, x: JTextFuseNet(cfg_j).init(
        k, x, method="init_probe"))(jax.random.PRNGKey(seed), jnp.zeros((1, *TFN_HW, 3))))
    k = cfg_j.max_words
    idx, jitter, shift = [], [], []
    for key in _step_keys(seed):
        kidx, kloss = jax.random.split(key)
        idx.append(np.array(jax.random.randint(kidx, (batch,), 0, dataset)))
        j_i, s_i = [], []
        for key_i in jax.random.split(kloss, batch):
            k1, k2, _ = jax.random.split(key_i, 3)
            j_i.append(np.array(jax.random.uniform(k1, (k, 4), minval=-0.15, maxval=0.15)))
            s_i.append(np.array(jax.random.uniform(k2, (k, 2), minval=40.0, maxval=120.0)))
        jitter.append(np.stack(j_i))
        shift.append(np.stack(s_i))
    losses, timing = [], {}
    _, tvars = TT.train_textfusenet_device(
        config=tcfg.TextFuseNetConfig(**TINY_TFN), **kw, device="cpu", init_params=init,
        losses=losses, timing=timing, batch_indices=idx, batch_jitter=jitter,
        batch_shift=shift)
    assert len(seen) == STEPS and timing["steps"] == STEPS
    print("losses", losses, seen)
    np.testing.assert_allclose(losses, np.asarray(seen, np.float64), rtol=LOSS_RTOL)
    jvars = jax.device_get(jvars)
    _check_tree(jvars, tvars, init, PARAM_ATOL)
    moved = [np.abs(_leaves(tvars)[p] - v).max() for p, v in _leaves(init).items()
             if p[0] == "batch_stats"]
    assert moved and max(moved) > 5 * PARAM_ATOL  # the statistics were stepped
