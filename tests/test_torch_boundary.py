"""The port's boundary registration (``marie_tpu_torch/models/boundary.py``,
``components/document_registration/``) and NMS (``ops/nms.py``,
``ops/box_ops.py``) against the JAX package's, on the CPU, on the same
numpy inputs and flax-layout trees.

Limits, and why:

* NMS keep masks and orders, box ops, the angle grid, the bilinear
  sampler, the rotation (``rotate_page`` vs ``_align_jit``) and the whole
  deskew path (box, angle, aligned page): equal.  The port rounds where
  XLA's CPU backend rounds (fused multiply-adds, numpy's float32
  cos/sin), and the deskew sweep's score, a ratio of float32 variances
  summed in another order, within SCORE_LIMIT (measured <= 5e-7);
* ``BoundaryNet`` (tiny, full width, trained ``boundary-synth``):
  FLOAT32_LIMIT (measured 6e-8);
* the warps: the 8x8 homography solve runs on the host (numpy's float32
  LAPACK) where XLA runs its own LU and triangular solves, so H differs
  by up to ~1.4e-6 relative (HOMOGRAPHY_LIMIT) and the sampled pixels
  move: ``warp_quad_to_page`` of a noise image, pixels equal in >=
  WARP_EQUAL and never more than 1 level apart on a well-conditioned quad
  (measured 99.93-99.96%).  On a text page the white paper flips between
  255 and 254: four weights that sum to 1 - 2^-24 give 254.99998, which
  the cast truncates, so a page warp is held to PAGE_WARP_EQUAL, never 2
  levels apart (measured 97.4%, ``composite_scan`` 96.0%, whose quad edge
  may also flip a pixel between page and background: at most EDGE_FLIPS
  of the pixels); the seeded regressor's quad is small and degenerate,
  its warp magnifies, and it may differ by MODEL_WARP_MAX (measured 96.9%,
  2 levels).

Pages are at most 256x320.
"""

import importlib
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from marie_tpu.components.document_registration import boundary as jbd
from marie_tpu.models import boundary as jb
from marie_tpu.models.configs import BoundaryConfig as JaxBoundaryConfig
from marie_tpu.ops import box_ops as jbox
from marie_tpu.preprocess.ops import _bilinear_hwc as jax_bilinear
from marie_tpu.registry.zoo import zoo_checkpoint
from marie_tpu_torch.components.document_registration import (
    DocumentBoundaryRegistration,
)
from marie_tpu_torch.components.document_registration import boundary as tbd
from marie_tpu_torch.models import boundary as tb
from marie_tpu_torch.models.configs import BoundaryConfig
from marie_tpu_torch.ops import box_ops, nms
from marie_tpu_torch.preprocess.ops import _bilinear_hwc
from marie_tpu_torch.registry.convert import init_flax_layout, load_model
from marie_tpu_torch.registry.zoo import ZOO_DIR

#: the module (``marie_tpu.ops`` exports its function under the same name)
jnms = importlib.import_module("marie_tpu.ops.nms")

FLOAT32_LIMIT = 1e-5
SCORE_LIMIT = 1e-4
HOMOGRAPHY_LIMIT = 1e-5
WARP_EQUAL = 0.999
PAGE_WARP_EQUAL = 0.95
EDGE_FLIPS = 1e-3
MODEL_WARP_MAX = 2


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _pages(idx, h=256, w=320):
    with np.load(os.path.join(ZOO_DIR, "pages.npz")) as data:
        return [np.ascontiguousarray(data["pages"][i][:h, :w]) for i in idx]


def _rgb(page):
    return np.stack([page] * 3, axis=-1)


# --- NMS and box ops ----------------------------------------------------------

def _boxes(rng, n, grid=None):
    xy = rng.uniform(0, 100, (n, 2))
    wh = rng.uniform(5, 40, (n, 2))
    boxes = np.concatenate([xy, xy + wh], axis=1).astype(np.float32)
    if grid:
        boxes = np.round(boxes / grid) * grid  # many equal boxes
    return boxes


@pytest.mark.parametrize("case", ["plain", "ties", "padded", "max_outputs", "threshold"])
def test_nms_matches_jax(case):
    rng = np.random.default_rng(["plain", "ties", "padded", "max_outputs",
                                 "threshold"].index(case))
    n = 48
    boxes = _boxes(rng, n, grid=10 if case == "ties" else None)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    if case == "ties":
        scores = np.round(scores * 4) / 4  # few distinct scores: ties decide order
    kwargs = {"iou_threshold": 0.5}
    if case == "padded":
        valid = rng.uniform(size=n) < 0.6
        kwargs["valid_mask"] = valid
    if case == "max_outputs":
        kwargs["max_outputs"] = 5
    if case == "threshold":
        kwargs["iou_threshold"] = 0.1
    want_keep, want_order = jnms.nms(jnp.asarray(boxes), jnp.asarray(scores),
                                     **{k: (jnp.asarray(v) if k == "valid_mask" else v)
                                        for k, v in kwargs.items()})
    keep, order = nms.nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                          **{k: (torch.from_numpy(v) if k == "valid_mask" else v)
                             for k, v in kwargs.items()}, device="cpu")
    np.testing.assert_array_equal(keep.numpy(), np.asarray(want_keep))
    np.testing.assert_array_equal(order.numpy(), np.asarray(want_order))
    assert 0 < int(keep.sum()) < n


def test_batched_nms_matches_jax():
    rng = np.random.default_rng(7)
    boxes = _boxes(rng, 40, grid=10)
    scores = np.round(rng.uniform(0, 1, 40) * 5).astype(np.float32) / 5
    classes = rng.integers(0, 3, 40)
    valid = rng.uniform(size=40) < 0.8
    want, want_order = jnms.batched_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                        jnp.asarray(classes), 0.4, jnp.asarray(valid))
    got, order = nms.batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                                 torch.from_numpy(classes), 0.4, torch.from_numpy(valid),
                                 device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(order.numpy(), np.asarray(want_order))


def test_rotated_nms_names_its_roadmap_item():
    """ROADMAP item 5 is done: ``rotated_nms`` no longer raises and keeps
    JAX's boxes (two overlapping copies, one far box)."""
    jnms_mod = importlib.import_module("marie_tpu.ops.nms")
    boxes = np.float32([[10, 10, 8, 4, 30], [10.5, 10, 8, 4, 30], [50, 50, 6, 6, -30]])
    scores = np.float32([0.5, 0.9, 0.7])
    want, want_order = jnms_mod.rotated_nms(jnp.asarray(boxes), jnp.asarray(scores), 0.5)
    got, order = nms.rotated_nms(torch.from_numpy(boxes), torch.from_numpy(scores), 0.5,
                                 device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(order.numpy(), np.asarray(want_order))
    assert got.tolist() == [False, True, True]


def test_nms_defaults_to_the_card():
    import inspect

    for fn in (nms.nms, nms.batched_nms, tb.warp_quad_to_page, tb.composite_scan):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert inspect.signature(DocumentBoundaryRegistration).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            nms.nms(torch.zeros((2, 4)), torch.zeros(2))
        with pytest.raises(RuntimeError):
            DocumentBoundaryRegistration(use_model=False)


@pytest.mark.parametrize("name", ["boxes_xywh_to_xyxy", "boxes_xyxy_to_xywh",
                                  "boxes_cxcywh_to_xyxy", "box_area"])
def test_box_converters_match_jax(name):
    boxes = _boxes(np.random.default_rng(3), 20)
    boxes[::4, 2] = boxes[::4, 0] - 3  # some inverted boxes
    want = np.asarray(getattr(jbox, name)(jnp.asarray(boxes)))
    np.testing.assert_array_equal(getattr(box_ops, name)(torch.from_numpy(boxes)).numpy(), want)


@pytest.mark.parametrize("name", ["box_iou", "box_intersection_over_min"])
def test_pairwise_box_overlap_matches_jax(name):
    rng = np.random.default_rng(4)
    a, b = _boxes(rng, 12, grid=5), _boxes(rng, 9, grid=5)
    b[0] = [5, 5, 5, 9]  # zero area
    want = np.asarray(getattr(jbox, name)(jnp.asarray(a), jnp.asarray(b)))
    got = getattr(box_ops, name)(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


# --- the regressor --------------------------------------------------------------

def _boundary_pair(cfg_port, cfg_jax, tree):
    from marie_tpu.models.boundary import BoundaryNet as JaxBoundaryNet

    model = load_model(cfg_port, tree, "cpu")
    return model, (lambda x: np.asarray(
        jax.jit(JaxBoundaryNet(cfg_jax).apply)(_jnp(tree), jnp.asarray(x))))


@pytest.mark.parametrize("width", ["tiny", "full"])
def test_boundary_net_matches_jax(width):
    cfg, jcfg = ((BoundaryConfig.tiny(), JaxBoundaryConfig.tiny()) if width == "tiny"
                 else (BoundaryConfig(), JaxBoundaryConfig()))
    model, ref = _boundary_pair(cfg, jcfg, init_flax_layout(cfg, 11))
    x = np.random.default_rng(2).random((2, *cfg.input_hw, 3), dtype=np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 8)
    np.testing.assert_allclose(got, ref(x), atol=FLOAT32_LIMIT, rtol=0)


def _trained_tree():
    from marie_tpu.registry.zoo import zoo_params

    return jax.tree_util.tree_map(np.asarray, jax.device_get(zoo_params("boundary-synth")))


@pytest.mark.skipif(zoo_checkpoint("boundary-synth") is None, reason="boundary ckpt not trained")
def test_trained_boundary_net_matches_jax():
    tree = _trained_tree()
    model, ref = _boundary_pair(BoundaryConfig(), JaxBoundaryConfig(), tree)
    scan, _ = _scan(_pages([4])[0], seed=4)
    x = np.asarray(jax.image.resize(jnp.asarray(scan, jnp.float32), (192, 256, 3),
                                    "bilinear") / 255.0)[None]
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref(x), atol=FLOAT32_LIMIT, rtol=0)


# --- warps ----------------------------------------------------------------------

def test_bilinear_sampler_matches_jax():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (60, 80, 3)).astype(np.float32)
    ys = rng.uniform(-2, 62, (50, 70)).astype(np.float32)
    xs = rng.uniform(-2, 82, (50, 70)).astype(np.float32)
    want = np.asarray(jax.jit(jax_bilinear)(jnp.asarray(img), jnp.asarray(ys), jnp.asarray(xs)))
    got = _bilinear_hwc(torch.from_numpy(img), torch.from_numpy(ys), torch.from_numpy(xs))
    np.testing.assert_array_equal(got.numpy(), want)


def _quads(n, h, w, seed):
    """Quads inside an (h, w) image: a rectangle inset 12-18 px, each
    corner moved by up to 6 px."""
    rng = np.random.default_rng(seed)
    rect = np.asarray([[12, 14], [w - 15, 12], [w - 13, h - 18], [16, h - 12]], np.float32)
    return [(rect + rng.uniform(-6, 6, (4, 2))).astype(np.float32) for _ in range(n)]


def test_homography_matches_jax():
    h, w = 256, 320
    rect = np.asarray([[0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]], np.float32)
    for q in _quads(6, h, w, 1):
        for src, dst in ((rect, q), (q, rect)):
            want = np.asarray(jax.jit(jb.homography_from_points)(jnp.asarray(src),
                                                                 jnp.asarray(dst)))
            got = tb.homography_from_points(src, dst)
            assert got.dtype == np.float32 and got[2, 2] == 1.0
            np.testing.assert_allclose(got, want, rtol=HOMOGRAPHY_LIMIT, atol=1e-9)


@pytest.mark.parametrize("seed", range(6))
def test_warp_quad_to_page_matches_jax(seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (120, 160, 3), dtype=np.uint8)
    (q,) = _quads(1, 120, 160, seed)
    want = np.asarray(jb.warp_quad_to_page(jnp.asarray(img), jnp.asarray(q), 120, 160))
    got = tb.warp_quad_to_page(img, q, 120, 160, device="cpu").numpy()
    d = np.abs(got.astype(np.int16) - want)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.mean(d == 0) >= WARP_EQUAL and d.max() <= 1


def _scan(page, seed, hw=(256, 320)):
    """The JAX trained-boundary test's recipe on a shipped page: the page
    placed into a skewed quad of a dark (40) canvas with uniform noise in
    [-10, 10], all from ``np.random.default_rng(seed)``."""
    h, w = hw
    rng = np.random.default_rng(seed)
    quad = (np.asarray([[0.16, 0.13], [0.88, 0.2], [0.84, 0.91], [0.12, 0.83]])
            * [w, h] + rng.normal(0, 4, (4, 2))).astype(np.float32)
    noise = rng.uniform(-10, 10, (h, w)).astype(np.float32)
    return tb.composite_scan(_rgb(page), quad, hw, 40.0, noise, device="cpu").numpy(), (
        quad, noise)


def test_composite_scan_matches_jax():
    page = _pages([2])[0]
    got, (quad, noise) = _scan(page, seed=3)
    want = np.asarray(jb.composite_scan(jnp.asarray(_rgb(page)), jnp.asarray(quad), (256, 320),
                                        40.0, jnp.asarray(noise)))
    d = np.abs(got.astype(np.int16) - want).max(axis=-1)
    assert got.shape == want.shape == (256, 320, 3)
    assert np.mean(d == 0) >= PAGE_WARP_EQUAL and np.mean(d > 1) <= EDGE_FLIPS


def test_quad_iou_matches_jax():
    a, b = _quads(2, 120, 160, 5)
    want = float(jb.quad_iou(jnp.asarray(a), jnp.asarray(b), (120, 160)))
    assert float(tb.quad_iou(a, b, (120, 160), device="cpu")) == want
    assert float(tb.quad_iou(a, a, (120, 160), device="cpu")) == 1.0


# --- the deskew path ----------------------------------------------------------

@pytest.mark.parametrize("max_deg,n", [(7.0, 57), (6.0, 49), (5.0, 41)])
def test_angle_grid_is_jax_linspace(max_deg, n):
    want = np.asarray(jax.jit(lambda a: jnp.linspace(-a, a, n) * (jnp.pi / 180.0))(max_deg))
    np.testing.assert_array_equal(tbd.angle_grid(max_deg, n), want)


def _skewed(idx, angles):
    return [tbd.rotate_page(torch.from_numpy(_rgb(p)), np.float32(np.radians(a))).numpy()
            for p, a in zip(_pages(idx), angles)]


def test_rotation_matches_jax_align():
    page = _rgb(_pages([0])[0])
    for deg in (2.3, -4.1):
        a = np.float32(np.radians(deg))
        want = np.asarray(jax.jit(jbd._align_jit)(jnp.asarray(page), jnp.asarray(a)))
        np.testing.assert_array_equal(tbd.rotate_page(torch.from_numpy(page), a).numpy(), want)


def test_deskew_sweep_matches_jax():
    from marie_tpu.preprocess.ops import to_grayscale as jax_gray

    for page in _skewed([1, 2, 3], (-4.1, 0.7, 3.9)):
        gray = jax_gray(jnp.asarray(page, jnp.float32) / 255.0)
        angle, score = jbd._deskew_jit(gray, 7.0, 57)
        angles = tbd.angle_grid(7.0, 57)
        for chunk in (None, 5, 57):
            best, got = tbd.deskew_sweep(tbd._gray(torch.from_numpy(page)), angles, chunk)
            assert angles[best] == np.float32(angle)
            assert abs(got - float(score)) <= SCORE_LIMIT


def _predictions_close(got, want, equal, max_diff, score_limit=SCORE_LIMIT):
    g, w = got.to_dict(), want.to_dict()
    assert (g["detected"], g["box"], g["angle"]) == (w["detected"], w["box"], w["angle"])
    assert abs(g["score"] - w["score"]) <= score_limit
    d = np.abs(got.aligned.astype(np.int16) - want.aligned)
    assert got.aligned.shape == want.aligned.shape
    assert np.mean(d == 0) >= equal and d.max() <= max_diff


@pytest.mark.parametrize("method", ["fit_to_page", "none"])
def test_deskew_registration_matches_jax(method):
    for page in _skewed([0, 5], (2.3, -3.2)):
        want = jbd.DocumentBoundaryRegistration(use_model=False,
                                                registration_method=method).register(page)
        got = DocumentBoundaryRegistration(use_model=False, registration_method=method,
                                           device="cpu").register(page)
        _predictions_close(got, want, 1.0, 0)


def test_deskew_registration_gray_page_and_run():
    page = _pages([6])[0]
    want = jbd.DocumentBoundaryRegistration(use_model=False).run(page)
    got = DocumentBoundaryRegistration(use_model=False, device="cpu").run(page)
    assert abs(got["meta"].pop("score") - want["meta"].pop("score")) <= SCORE_LIMIT
    assert got["meta"] == want["meta"]
    np.testing.assert_array_equal(got["aligned"], np.asarray(want["aligned"]))


# --- the model path -------------------------------------------------------------

@pytest.mark.parametrize("refine", [True, False])
def test_model_registration_matches_jax(refine):
    tree = init_flax_layout(BoundaryConfig(), 0)
    scan, _ = _scan(_pages([7])[0], seed=7)
    want = jbd.DocumentBoundaryRegistration(model_variables=_jnp(tree),
                                            model_config=JaxBoundaryConfig(),
                                            edge_refine=refine).register(scan)
    reg = DocumentBoundaryRegistration(model_variables=tree, model_config=BoundaryConfig(),
                                       edge_refine=refine, device="cpu")
    assert reg.trained
    _predictions_close(reg.register(scan), want, PAGE_WARP_EQUAL, MODEL_WARP_MAX)


def test_seeded_regressor_when_the_zoo_lacks_the_tree():
    """With no tree the port draws ``BoundaryConfig()`` from its seed (the
    zoo of the port has no ``boundary-synth``) and says so."""
    reg = DocumentBoundaryRegistration(device="cpu")
    assert reg.model is not None and not reg.trained
    assert reg.model_config == BoundaryConfig()
    want = load_model(BoundaryConfig(), init_flax_layout(BoundaryConfig(), tbd.SEED), "cpu")
    for a, b in zip(reg.model.parameters(), want.parameters()):
        assert torch.equal(a, b)
    assert DocumentBoundaryRegistration(use_model=False, device="cpu").model is None


@pytest.mark.skipif(zoo_checkpoint("boundary-synth") is None, reason="boundary ckpt not trained")
def test_trained_model_registration_matches_jax():
    tree = _trained_tree()
    for seed, page in zip((8, 9), _pages([8, 9])):
        scan, _ = _scan(page, seed=seed)
        want = jbd.DocumentBoundaryRegistration(model_variables=_jnp(tree),
                                                model_config=JaxBoundaryConfig()).register(scan)
        got = DocumentBoundaryRegistration(model_variables=tree, model_config=BoundaryConfig(),
                                           device="cpu").register(scan)
        assert got.detected
        _predictions_close(got, want, PAGE_WARP_EQUAL, 1)


def test_refine_quad_corners_matches_jax():
    scan, (quad, _) = _scan(_pages([10])[0], seed=10)
    prior = quad + np.asarray([[25, -18], [-30, 22], [28, 15], [-20, -25]], np.float32)
    for q in (prior, quad + 300.0):
        np.testing.assert_array_equal(tbd.refine_quad_corners(scan, q),
                                      jbd.refine_quad_corners(scan, q))
    assert np.abs(tbd.refine_quad_corners(scan, prior) - quad).max() < 3.0
