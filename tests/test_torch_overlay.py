"""The port's overlay cleanup (``marie_tpu_torch/models/pix2pix.py``,
``marie_tpu_torch/overlay/overlay.py``) against the JAX package's, on the
CPU, on the same numpy inputs and flax-layout trees.

Limits, and why:

* the generator's layers and the tiny generator in float32: 1e-5
  (float32 summed in another order; measured ~2e-6);
* the antialiased resizes: 1e-6 in float32, equal in bfloat16 (the same
  weights, rounded after each axis in ``jnp.einsum``'s order);
* the trained ``pix2pix-synth`` tree in float32 ``segment_batch``: blended
  pixels equal in >= 99.9% and never more than 1 gray level apart (a
  float32 value on a rounding boundary of ``clip((fake + 1) * 127.5)``),
  masks equal in >= 99.95% (measured: 99.987-99.994% and 100%; the CPU
  path computes the last tanh as XLA's CPU does, which saturates to
  exactly 1 where the exact tanh does not);
* in bfloat16: masks equal in >= 99.8%, blended pixels within 1 gray
  level in >= 99% and within 4 in >= 99.8% (measured: masks 99.90-99.96%,
  pixels equal 97.4% and 95.0%, within 1 99.33-99.59%, within 4
  99.95-99.99%, larger gaps only on mask flips: torch's bf16 convolutions
  add the bias before their one rounding, XLA's CPU after it);
* ``segment_frame`` (float32) on an RGB page and a page over its bucket:
  the same limits as float32 ``segment_batch``, where the masks agree
  (measured on the RGB page: 99.995% equal, one mask pixel flipped).

Pages are at most 512x384; the oversize case uses a 256x192 bucket.
"""

import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp
import flax.linen as fnn

from marie_tpu.models.configs import Pix2PixConfig as JaxPix2PixConfig
from marie_tpu.models.pix2pix import ResnetGenerator as JaxGenerator
from marie_tpu.overlay.overlay import OverlayProcessor as JaxOverlay
from marie_tpu.overlay.overlay import _segment_batch_gray_jit
from marie_tpu.preprocess import BucketSpec as JaxBucketSpec
from marie_tpu_torch.models.configs import Pix2PixConfig
from marie_tpu_torch.models.pix2pix import GroupNorm, SameConv2d, SameConvTranspose2d
from marie_tpu_torch.overlay.overlay import OverlayProcessor, _segment_batch_gray, resize_linear
from marie_tpu_torch.preprocess.buckets import BucketSpec
from marie_tpu_torch.preprocess.resize import resize_nearest_u8
from marie_tpu_torch.registry.convert import from_flax, init_flax_layout, load_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_ATOL = 1e-5
RESIZE_ATOL = 1e-6
BLEND_EQUAL = 0.999
MASK_EQUAL_F32 = 0.9995
MASK_EQUAL_BF16 = 0.998
BF16_WITHIN_1 = 0.99
BF16_WITHIN_4 = 0.998


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("hw", [(6, 8), (7, 5), (9, 9), (12, 16)])
def test_conv_transpose_same_stride2_matches_flax(hw):
    """lax pads the dilated input (2, 1) with the kernel as stored; the
    port's transposed convolution pads (2, 2) with the kernel flipped and
    crops the last row and column."""
    rng = np.random.default_rng(hw[0] * 31 + hw[1])
    x = rng.standard_normal((2, *hw, 5)).astype(np.float32)
    m = fnn.ConvTranspose(4, (3, 3), strides=(2, 2), padding="SAME")
    v = jax.device_get(m.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    want = np.asarray(m.apply(_jnp(v), jnp.asarray(x)))
    got = _nhwc(from_flax(v, SameConvTranspose2d(5, 4))(_nchw(x)))
    assert got.shape == want.shape == (2, 2 * hw[0], 2 * hw[1], 4)
    np.testing.assert_allclose(got, want, atol=F32_ATOL)


@pytest.mark.parametrize("k,stride,hw", [(3, 2, (8, 6)), (3, 2, (7, 9)), (7, 1, (9, 5)),
                                         (3, 1, (5, 4))])
def test_same_conv_matches_flax(k, stride, hw):
    """flax's SAME padding: (0, 1) on an even side at stride 2."""
    rng = np.random.default_rng(k * 10 + stride)
    x = rng.standard_normal((2, *hw, 3)).astype(np.float32)
    m = fnn.Conv(4, (k, k), strides=(stride, stride), padding="SAME")
    v = jax.device_get(m.init(jax.random.PRNGKey(2), jnp.asarray(x)))
    want = np.asarray(m.apply(_jnp(v), jnp.asarray(x)))
    got = _nhwc(from_flax(v, SameConv2d(3, 4, k, stride))(_nchw(x)))
    np.testing.assert_allclose(got, want, atol=F32_ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norm_group_size_1_matches_flax(dtype):
    """Instance norm with scale and bias, epsilon 1e-6, E[x^2] - E[x]^2
    statistics in float32, one rounding to the input's dtype."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 9, 7, 6)) * 3 + 1).astype(np.float32)
    tree = {"params": {"scale": (1 + 0.1 * rng.standard_normal(6)).astype(np.float32),
                       "bias": (0.1 * rng.standard_normal(6)).astype(np.float32)}}
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    m = fnn.GroupNorm(num_groups=None, group_size=1)
    want = np.asarray(m.apply(jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), tree),
                              jnp.asarray(x, jdt)).astype(jnp.float32))
    norm = from_flax(tree, GroupNorm(6)).to(tdt)
    got = _nhwc(norm(_nchw(x).to(tdt)).float())
    # bf16: the same float32 math, then one rounding: equal
    np.testing.assert_allclose(got, want, atol=F32_ATOL if dtype == "float32" else 0.0)


@pytest.mark.parametrize("src,dst", [((64, 48), (32, 24)), ((33, 17), (16, 8)),
                                     ((16, 12), (32, 24)), ((20, 10), (40, 20)),
                                     ((48, 64), (24, 32))])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_antialiased_resize_matches_jax(src, dst, dtype):
    """``jax.image.resize(..., "linear")`` antialiases a downscale (a
    widened triangle, renormalised at the edges) and is half-pixel
    bilinear up; both as JAX's weight matrices, edges included."""
    rng = np.random.default_rng(src[0] + dst[1])
    x = rng.uniform(-1, 1, (2, *src, 3)).astype(np.float32)
    shape = (2, *dst, 3)
    if dtype == "float32":
        want = np.asarray(jax.image.resize(jnp.asarray(x), shape, "linear"))
        got = resize_linear(torch.from_numpy(x), *dst).numpy()
        np.testing.assert_allclose(got, want, atol=RESIZE_ATOL)
    else:
        want = np.asarray(jax.image.resize(jnp.asarray(x, jnp.bfloat16), shape, "linear")
                          .astype(jnp.float32))
        got = resize_linear(torch.from_numpy(x).bfloat16(), *dst).float().numpy()
        np.testing.assert_array_equal(got, want)
    if dst[0] < src[0] and dtype == "float32":
        # the library call that computes the same function, for reference
        lib = torch.nn.functional.interpolate(
            torch.from_numpy(x).permute(0, 3, 1, 2), dst, mode="bilinear",
            antialias=True, align_corners=False).permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(lib, want, atol=RESIZE_ATOL)


def test_seeded_tree_matches_flax_init_layout():
    """``init_flax_layout`` gives the flax generator's tree: same paths,
    same shapes."""
    cfg = Pix2PixConfig()
    tree = init_flax_layout(cfg, 0)
    flax_tree = jax.eval_shape(JaxGenerator(JaxPix2PixConfig()).init, jax.random.PRNGKey(0),
                               jnp.zeros((1, 32, 32, 3)))
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)
    assert shapes == jax.tree_util.tree_map(lambda a: tuple(a.shape), dict(flax_tree))
    n = sum(a.size for a in jax.tree_util.tree_leaves(tree))
    assert 11_000_000 < n < 12_000_000  # ~11.4 M parameters at full width


def test_tiny_generator_matches_flax():
    cfg = Pix2PixConfig.tiny()
    tree = init_flax_layout(cfg, 3)
    x = np.random.default_rng(4).uniform(-1, 1, (2, 32, 24, 3)).astype(np.float32)
    want = np.asarray(JaxGenerator(JaxPix2PixConfig.tiny()).apply(_jnp(tree), jnp.asarray(x)))
    with torch.inference_mode():
        got = load_model(cfg, tree, device="cpu")(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=F32_ATOL)


# --- the trained tree -----------------------------------------------------------

@pytest.fixture(scope="module")
def synth():
    """(JAX processor, port processor) on the trained ``pix2pix-synth``
    tree: orbax on the JAX side, the same numpy tree bridged into the
    port."""
    from marie_tpu.registry.checkpoints import load_params

    tree = jax.device_get(load_params(os.path.join(REPO, "model_zoo", "pix2pix-synth")))
    jax_proc = JaxOverlay(config=JaxPix2PixConfig.synth(), variables=_jnp(tree))
    port = OverlayProcessor(config=Pix2PixConfig.synth(), variables=tree, device="cpu")
    assert jax_proc.trained and port.trained
    return jax_proc, port


@pytest.fixture(scope="module")
def dirty_rgb():
    """Two RGB 512x384 dirty pages of the JAX trainer's drawer (grays and
    coloured tints)."""
    from marie_tpu.train.overlay import render_overlay_pair

    rng = np.random.default_rng(3)
    return np.stack([render_overlay_pair(rng, (512, 384))[1] for _ in range(2)])


@pytest.fixture(scope="module")
def dirty(dirty_rgb):
    """The same pages made gray."""
    return dirty_rgb.mean(-1).astype(np.uint8)


@pytest.mark.parametrize("gan_scale", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_trained_segment_batch_matches_jax(synth, dirty, gan_scale, dtype):
    jax_proc, port = synth
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    mj, bj = jax.device_get(_segment_batch_gray_jit(
        jax_proc.model, jax_proc.variables, jnp.asarray(dirty), compute_dtype=jdt,
        gan_scale=gan_scale))
    mt, bt = (t.numpy() for t in port._forward(_segment_batch_gray, dtype,
                                                torch.from_numpy(dirty), gan_scale))
    diff = np.abs(bj.astype(np.int16) - bt)
    mask_equal = np.mean(mj == mt)
    assert 0.01 < np.mean(mt > 0) < 0.5  # the generator marks overlays, not the page
    if dtype == "float32":
        assert mask_equal >= MASK_EQUAL_F32
        assert np.mean(diff == 0) >= BLEND_EQUAL and diff.max() <= 1
    else:
        assert mask_equal >= MASK_EQUAL_BF16
        assert np.mean(diff <= 1) >= BF16_WITHIN_1
        assert np.mean(diff <= 4) >= BF16_WITHIN_4
    # the public path: chunks of 2 pages, no gate
    port.gan_scale = jax_proc.gan_scale = gan_scale
    got = np.stack(port.segment_batch(list(dirty), chunk=2, compute_dtype=dtype, gate="off"))
    np.testing.assert_array_equal(got, bt)


def test_overlay_scores_and_gate_match_jax(synth, dirty):
    """The host gate on a clean page, the dirty pages and an RGB page with a
    coloured stamp; the gated batch passes the clean page unchanged and
    cleans the rest as JAX does."""
    jax_proc, port = synth
    clean = np.full((512, 384), 255, np.uint8)
    clean[100:110, 40:300:7] = 20
    rgb = np.stack([clean] * 3, axis=-1)
    rgb[200:260, 100:220, 2] = 40
    frames = [clean, dirty[0], rgb, dirty[1]]
    assert port.overlay_scores(frames) == jax_proc.overlay_scores(frames)
    pages = [clean, dirty[0], clean.copy(), dirty[1]]
    port.gan_scale = jax_proc.gan_scale = 2
    want = jax_proc.segment_batch(pages, chunk=2, compute_dtype=jnp.float32)
    calls = port.calls
    got = port.segment_batch(pages, chunk=2, compute_dtype="float32")
    assert port.calls == calls + 1  # one chunk: the two dirty pages
    np.testing.assert_array_equal(got[0], clean)
    np.testing.assert_array_equal(got[2], clean)
    for g, w in zip(got, want):
        d = np.abs(g.astype(np.int16) - w)
        assert np.mean(d == 0) >= BLEND_EQUAL and d.max() <= 1


@pytest.mark.parametrize("case", ["rgb", "oversize"])
def test_segment_frame_matches_jax(synth, dirty, dirty_rgb, case):
    """``segment_frame`` on an RGB page (3 channels in, 3 out) and on a
    gray page over its bucket (area down, the generator, nearest and
    bilinear back up): pixels equal in >= 99.9%, and never more than 1
    apart where the masks agree (a flipped mask pixel swaps the page's
    own pixel for the generator's)."""
    jax_proc, port = synth
    if case == "rgb":
        frame = dirty_rgb[0]
    else:
        frame = dirty[0]
        jax_proc.buckets, port.buckets = JaxBucketSpec(((256, 192),)), BucketSpec(((256, 192),))
    try:
        want = jax_proc.segment_frame("k", frame)
        got = port.segment_frame("k", frame)
    finally:
        jax_proc.buckets, port.buckets = JaxBucketSpec(), BucketSpec()
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1].shape == want[1].shape and got[2].shape == want[2].shape == frame.shape
    assert np.mean(got[1] == want[1]) >= MASK_EQUAL_F32
    d = np.abs(got[2].astype(np.int16) - want[2])
    same_mask = (got[1] == want[1]).reshape(d.shape[:2])
    assert np.mean(d == 0) >= BLEND_EQUAL and d[same_mask].max() <= 1


def test_default_processor_seeds_full_width_and_refuses_without_card():
    """With no tree and no ``pix2pix-synth`` in the port's zoo, the default
    is ``Pix2PixConfig()`` from the seed, untrained; the default device is
    the card."""
    import inspect

    from marie_tpu_torch.registry.zoo import zoo_checkpoint

    assert inspect.signature(OverlayProcessor).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            OverlayProcessor()
    if zoo_checkpoint("pix2pix-synth") is None:
        proc = OverlayProcessor(device="cpu")
        assert not proc.trained and proc.config == Pix2PixConfig()


_NEAREST_IMAGES = st.tuples(st.integers(1, 90), st.integers(1, 90), st.sampled_from([0, 1, 3]),
                            st.integers(0, 2**16))


@settings(max_examples=80, deadline=None)
@given(_NEAREST_IMAGES, st.integers(1, 200), st.integers(1, 200))
def test_resize_nearest_matches_cv2(image, dw, dh):
    """Up, down and mixed scales, bit for bit."""
    import cv2

    h, w, c, seed = image
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w) if c == 0 else (h, w, c), dtype=np.uint8)
    want = cv2.resize(img, (dw, dh), interpolation=cv2.INTER_NEAREST)
    got = resize_nearest_u8(img, (dw, dh))
    np.testing.assert_array_equal(got, want.reshape(got.shape))
