"""The port's rotated ops and deformable convolution
(``marie_tpu_torch/ops/rotated_iou.py``, ``nms.py::rotated_nms``,
``roi_align.py::roi_align_rotated``, ``deform_conv.py``) against the JAX
package's on the CPU, within 1e-5: angles 0, 45, 90 and -30 degrees;
identical, contained, touching and disjoint boxes; deformable
convolution v1 and v2 with strides, padding and dilation.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from marie_tpu.ops.deform_conv import deform_conv2d as jax_deform_conv2d
from marie_tpu.ops.nms import rotated_nms as jax_rotated_nms
from marie_tpu.ops.roi_align import roi_align_rotated as jax_roi_align_rotated
from marie_tpu.ops.rotated_iou import box_corners as jax_box_corners
from marie_tpu.ops.rotated_iou import pairwise_rotated_iou as jax_pairwise
from marie_tpu.ops.rotated_iou import rotated_iou as jax_rotated_iou
from marie_tpu_torch.ops.deform_conv import deform_conv2d
from marie_tpu_torch.ops.nms import rotated_nms
from marie_tpu_torch.ops.roi_align import roi_align_rotated
from marie_tpu_torch.ops.rotated_iou import box_corners, pairwise_rotated_iou, rotated_iou

ATOL = 1e-5
ANGLES = (0.0, 45.0, 90.0, -30.0)

#: (name, box a, box b, the IoU where it is known)
PAIRS = [
    ("identical", [50, 40, 30, 10, 45], [50, 40, 30, 10, 45], 1.0),
    ("contained", [50, 50, 40, 40, -30], [50, 50, 10, 10, -30], 100.0 / 1600.0),
    ("touching", [10, 10, 10, 10, 0], [20, 10, 10, 10, 0], 0.0),
    ("disjoint", [10, 10, 4, 4, 90], [80, 80, 6, 2, 45], 0.0),
    ("crossed", [30, 30, 40, 8, 0], [30, 30, 40, 8, 90], 64.0 / (2 * 320 - 64)),
    ("rotated_copy", [30, 30, 20, 10, 45], [32, 29, 20, 10, -30], None),
]


def _boxes(seed, n):
    rng = np.random.default_rng(seed)
    out = np.concatenate([rng.uniform(0, 100, (n, 2)), rng.uniform(2, 40, (n, 2)),
                          rng.choice(ANGLES, (n, 1))], axis=1)
    return out.astype(np.float32)


def test_box_corners_match():
    boxes = _boxes(0, 12)
    np.testing.assert_allclose(box_corners(torch.from_numpy(boxes)).numpy(),
                               np.asarray(jax_box_corners(jnp.asarray(boxes))),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("name,a,b,known", PAIRS, ids=[p[0] for p in PAIRS])
def test_rotated_iou_pairs(name, a, b, known):
    a, b = np.float32(a), np.float32(b)
    want = float(jax_rotated_iou(jnp.asarray(a), jnp.asarray(b)))
    got = float(rotated_iou(torch.from_numpy(a), torch.from_numpy(b), device="cpu"))
    assert abs(got - want) <= ATOL
    if known is not None:
        assert abs(got - known) <= ATOL, (got, known)
    assert abs(float(rotated_iou(torch.from_numpy(b), torch.from_numpy(a), device="cpu"))
               - got) <= ATOL


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_pairwise_rotated_iou_matches(seed):
    a, b = _boxes(seed, 17), _boxes(seed + 10, 9)
    b[:3] = a[:3]  # identical pairs on the diagonal
    want = np.asarray(jax_pairwise(jnp.asarray(a), jnp.asarray(b)))
    got = pairwise_rotated_iou(torch.from_numpy(a), torch.from_numpy(b), device="cpu").numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert got.shape == (17, 9)
    np.testing.assert_allclose(np.diag(got[:3, :3]), 1.0, atol=ATOL)


@pytest.mark.parametrize("max_outputs", [None, 3])
def test_rotated_nms_matches(max_outputs):
    boxes = _boxes(4, 24)
    boxes[8:16] = boxes[:8] + np.float32([1, -1, 0, 0, 0])  # near copies to suppress
    scores = np.random.default_rng(5).random(24).astype(np.float32)
    scores[3] = scores[4]  # a tie: the lower index ranks first
    valid = np.ones(24, bool)
    valid[20:] = False
    jk, jo = jax_rotated_nms(jnp.asarray(boxes), jnp.asarray(scores), 0.3,
                             jnp.asarray(valid), max_outputs=max_outputs)
    keep, order = rotated_nms(torch.from_numpy(boxes), torch.from_numpy(scores), 0.3,
                              torch.from_numpy(valid), max_outputs=max_outputs, device="cpu")
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(order.numpy(), np.asarray(jo))
    assert keep.sum() < valid.sum()


@pytest.mark.parametrize("angle", ANGLES)
def test_roi_align_rotated_matches(angle):
    rng = np.random.default_rng(int(angle) + 40)
    feats = rng.standard_normal((2, 3, 24, 32)).astype(np.float32)
    rois = np.array([[0, 16, 12, 10, 6, angle], [1, 8.5, 20.25, 14, 4, angle],
                     [0, 30, 2, 12, 12, angle],  # past the map's edge
                     [1, 5, 5, 0.5, 0.5, angle]], np.float32)
    for scale, size, ratio in ((1.0, 7, 2), (0.5, 4, 3)):
        want = np.asarray(jax_roi_align_rotated(jnp.asarray(feats), jnp.asarray(rois), size,
                                                scale, ratio))
        got = roi_align_rotated(torch.from_numpy(feats), torch.from_numpy(rois), size, scale,
                                ratio, device="cpu").numpy()
        assert got.shape == (4, 3, size, size)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("v2,stride,padding,dilation", [
    (False, 1, 1, 1), (True, 1, 1, 1), (True, 2, 0, 1), (False, 1, 2, 2)])
def test_deform_conv2d_matches(v2, stride, padding, dilation):
    rng = np.random.default_rng(7 + stride + 2 * dilation)
    x = rng.standard_normal((2, 4, 11, 13)).astype(np.float32)
    w = (rng.standard_normal((5, 4, 3, 3)) / 6).astype(np.float32)
    bias = rng.standard_normal(5).astype(np.float32)
    ho = (11 + 2 * padding - dilation * 2 - 1) // stride + 1
    wo = (13 + 2 * padding - dilation * 2 - 1) // stride + 1
    off = (rng.standard_normal((2, 18, ho, wo)) * 2).astype(np.float32)
    off[0, :, 0, 0] = 20.0  # samples off the map
    mask = rng.random((2, 9, ho, wo)).astype(np.float32) if v2 else None
    want = np.asarray(jax_deform_conv2d(
        jnp.asarray(x), jnp.asarray(off), jnp.asarray(w),
        None if mask is None else jnp.asarray(mask), jnp.asarray(bias),
        stride=stride, padding=padding, dilation=dilation))
    got = deform_conv2d(torch.from_numpy(x), torch.from_numpy(off), torch.from_numpy(w),
                        None if mask is None else torch.from_numpy(mask),
                        torch.from_numpy(bias), stride, padding, dilation,
                        device="cpu").numpy()
    assert got.shape == want.shape == (2, 5, ho, wo)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_zero_offsets_are_a_plain_convolution():
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((1, 3, 9, 8)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((4, 3, 3, 3)).astype(np.float32))
    off = torch.zeros(1, 18, 9, 8)
    got = deform_conv2d(x, off, w, device="cpu")
    want = torch.nn.functional.conv2d(x, w, padding=1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)


def test_rotated_ops_default_to_the_card():
    import inspect

    for fn in (rotated_iou, pairwise_rotated_iou, rotated_nms, roi_align_rotated,
               deform_conv2d):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            pairwise_rotated_iou(torch.zeros(1, 5), torch.zeros(1, 5))
