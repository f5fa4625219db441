"""Port host-side ops against the JAX package, bit for bit: the upload
unpackers, page preprocessing (normalize, grayscale, Otsu) and the
run-domain connected components with their pixel-domain oracle."""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from marie_tpu.ocr import fused as jfused
from marie_tpu.ops import component_boxes, component_boxes_runs_cc, connected_components
from marie_tpu.preprocess import ops as jops
from marie_tpu_torch.ocr import fused as tfused
from marie_tpu_torch.preprocess import ops as tops

# the package's ``connected_components`` is the function, as in the JAX package
tcc = importlib.import_module("marie_tpu_torch.ops.connected_components")


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_unpackers_bit_exact(bits):
    rng = np.random.default_rng(bits)
    packed = rng.integers(0, 256, (2, 16, 96 * bits // 8), dtype=np.uint8)
    want = np.asarray(jfused._unpack_bits(jnp.asarray(packed), bits))
    got = tfused._unpack_bits(torch.from_numpy(packed), bits).numpy()
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_norm_pack_bits():
    for flag in (False, None, True, 1, 2, 4):
        assert tfused._norm_pack_bits(flag) == jfused._norm_pack_bits(flag)
    with pytest.raises(ValueError):
        tfused._norm_pack_bits(3)


def test_geometric_step_caps():
    eff_w = np.asarray([0, 1, 23, 24, 100, 320, 1000], np.int32)
    want = np.asarray(jfused._geometric_step_caps(jnp.asarray(eff_w), 48, 17))
    got = tfused._geometric_step_caps(torch.from_numpy(eff_w), 48, 17).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("gray", [True, False])
def test_page_preprocessing_bit_exact(gray):
    rng = np.random.default_rng(11 + gray)
    img = rng.integers(0, 256, (2, 96, 128, 3), dtype=np.uint8)
    if gray:
        img[..., 1] = img[..., 0]
        img[..., 2] = img[..., 0]
    import jax

    rgb_j = np.array(jax.jit(jax.vmap(jops.normalize_page))(jnp.asarray(img)))
    rgb_t = tops.normalize_page(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(rgb_t, rgb_j)
    gray_j = np.array(jax.vmap(jops.to_grayscale)(jnp.asarray(rgb_j)))
    gray_t = tops.to_grayscale(torch.from_numpy(rgb_j)).numpy()
    np.testing.assert_array_equal(gray_t, gray_j)
    ink_j = np.asarray(jax.vmap(jops.otsu_binarize)(jnp.asarray(gray_j)))
    ink_t = tops.otsu_binarize(torch.from_numpy(gray_j)).numpy()
    np.testing.assert_array_equal(ink_t, ink_j)


def _assert_stats_equal(got, want, msg=""):
    for field in ("boxes", "areas", "scores", "valid"):
        g = got[field].numpy()
        w = np.asarray(want[field])
        assert g.dtype == w.dtype, f"{msg}/{field}: {g.dtype} vs {w.dtype}"
        np.testing.assert_array_equal(g, w, err_msg=f"{msg}/{field}")


def _blob_mask(rng, h=64, w=96):
    mask = np.zeros((h, w), bool)
    for _ in range(25):
        y, x = rng.integers(0, h - 6), rng.integers(0, w - 10)
        mask[y:y + rng.integers(1, 6), x:x + rng.integers(1, 9)] = True
    for _ in range(5):  # diagonal-only touches (8-connectivity)
        y, x = rng.integers(1, h - 4), rng.integers(1, w - 6)
        mask[y, x] = True
        mask[y + 1, x + 1] = True
    return mask


@pytest.mark.parametrize("k", [8, 64])
def test_runs_cc_bit_exact_on_blob_masks(k):
    """The ``test_ops_roi_cc.py`` blob cases, batched in one call."""
    rng = np.random.default_rng(23)
    masks, scores = [], []
    for _ in range(6):
        m = _blob_mask(rng)
        masks.append(m)
        scores.append((rng.random(m.shape) * m).astype(np.float32))
    got = tcc.component_boxes_runs_cc(torch.from_numpy(np.stack(masks)),
                                      torch.from_numpy(np.stack(scores)),
                                      max_components=k)
    for i, (m, s) in enumerate(zip(masks, scores)):
        want = component_boxes_runs_cc(jnp.asarray(m), jnp.asarray(s), max_components=k)
        _assert_stats_equal({f: v[i] for f, v in got.items()}, want, f"page{i}/k{k}")
        labels = connected_components(jnp.asarray(m))
        oracle = component_boxes(labels, jnp.asarray(s), max_components=k)
        np.testing.assert_allclose(got["boxes"][i].numpy(), np.asarray(oracle["boxes"]))


def test_runs_cc_empty_full_and_no_scores():
    empty = tcc.component_boxes_runs_cc(torch.zeros(16, 32, dtype=torch.bool), None, 8)
    _assert_stats_equal(empty, component_boxes_runs_cc(jnp.zeros((16, 32), bool), None, 8))
    full = tcc.component_boxes_runs_cc(torch.ones(16, 32, dtype=torch.bool), None, 8)
    _assert_stats_equal(full, component_boxes_runs_cc(jnp.ones((16, 32), bool), None, 8))
    assert full["boxes"][0].tolist() == [0, 0, 32, 16]


def test_runs_cc_adversarial_shapes_and_run_budget():
    """Bars, bends and a serpentine (propagation depth), then the same
    mask under a 2-run budget, where runs past the budget are dropped
    exactly as the JAX version drops them."""
    mask = np.zeros((128, 128), bool)
    mask[4:120, 8] = True
    mask[10:60, 20:24] = True
    mask[56:60, 20:50] = True
    mask[80:84, 30:70] = True
    mask[80:120, 66:70] = True
    mask[116:120, 30:70] = True
    y = 5
    for i in range(10):
        mask[y:y + 2, 40 + 6 * i:48 + 6 * i] = True
        mask[y:y + 8, 46 + 6 * i] = True
        y += 6
    scores = (np.random.default_rng(5).random(mask.shape) * mask).astype(np.float32)
    for runs in (48, 2):
        got = tcc.component_boxes_runs_cc(torch.from_numpy(mask), torch.from_numpy(scores),
                                          max_components=16, max_runs_per_row=runs)
        want = component_boxes_runs_cc(jnp.asarray(mask), jnp.asarray(scores),
                                       max_components=16, max_runs_per_row=runs)
        _assert_stats_equal(got, want, f"runs{runs}")


def test_pixel_connected_components_oracle():
    rng = np.random.default_rng(9)
    for _ in range(3):
        m = _blob_mask(rng)
        got = tcc.connected_components(torch.from_numpy(m)).numpy()
        want = np.asarray(connected_components(jnp.asarray(m)))
        np.testing.assert_array_equal(got, want)
