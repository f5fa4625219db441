"""Port kernels K1 (word crops) and K2 (fused attention): their plain
PyTorch versions against the JAX package on the CPU.  The CUDA kernels
are held against these plain versions on the card in
``test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from marie_tpu.models.layers import SelfAttention as JaxSelfAttention
from marie_tpu.ops.pallas.crop_resize import crop_resize_pallas
from marie_tpu.ops.pallas.flash_attention import _attention_reference, flash_attention
from marie_tpu.preprocess.ops import crop_resize_pages
from marie_tpu_torch.ops.kernels import crop_resize as k1
from marie_tpu_torch.models.layers import SelfAttention, _merge
from marie_tpu_torch.ops.kernels import flash_attention as k2
from marie_tpu_torch.registry.convert import from_flax


def _crop_case(seed, p=2, h=256, w=384, n=8, max_bh=28.0):
    rng = np.random.default_rng(seed)
    pages = rng.integers(0, 255, (p, h, w), dtype=np.uint8)
    x0 = rng.uniform(0, w - 80, n)
    y0 = rng.uniform(0, h - 30, n)
    boxes = np.stack(
        [x0, y0, x0 + rng.uniform(20, 80, n), y0 + rng.uniform(10, max_bh, n)],
        axis=-1,
    ).astype(np.float32)
    pidx = rng.integers(0, p, n).astype(np.int32)
    return pages, pidx, boxes


def _port_crop(pages, pidx, boxes, oh, ow):
    crops, eff_w = k1.crop_resize(torch.from_numpy(pages), torch.from_numpy(pidx),
                                  torch.from_numpy(boxes), oh, ow)
    return crops.numpy(), eff_w.numpy()


@pytest.mark.parametrize("seed", [0, 3])
def test_crop_plain_matches_gather_and_pallas(seed):
    """K1's plain version against ``crop_resize_pages`` and the Pallas
    kernel in interpret mode (boxes under its 64-row window), atol 1e-5."""
    pages, pidx, boxes = _crop_case(seed)
    got, got_w = _port_crop(pages, pidx, boxes, 32, 128)
    want, want_w = crop_resize_pages(jnp.asarray(pages), jnp.asarray(pidx),
                                     jnp.asarray(boxes), 32, 128)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
    np.testing.assert_array_equal(got_w, np.asarray(want_w))
    pal, pal_w = crop_resize_pallas(jnp.asarray(pages), jnp.asarray(pidx),
                                    jnp.asarray(boxes), 32, 128, window=64,
                                    interpret=True)
    np.testing.assert_allclose(got, np.asarray(pal), atol=1e-5)
    np.testing.assert_array_equal(got_w, np.asarray(pal_w))


def test_crop_plain_edges_and_tall_boxes():
    """Page-edge boxes and boxes taller than the TPU kernel's window: the
    port has no window, so it matches the gather path everywhere."""
    rng = np.random.default_rng(7)
    pages = rng.integers(0, 255, (2, 512, 256), dtype=np.uint8)
    boxes = np.asarray(
        [
            [0.0, 0.0, 60.0, 18.0],  # top-left corner
            [200.0, 494.0, 256.0, 512.0],  # bottom-right corner
            [10.0, 500.0, 80.0, 511.5],  # fractional bottom edge
            [5.0, 3.0, 250.0, 400.0],  # taller than any slab window
            [30.0, 100.0, 31.0, 101.0],  # 1x1 box
            [100.0, 50.0, 100.0, 50.0],  # degenerate: clamped to 1 px
        ],
        np.float32,
    )
    pidx = np.asarray([0, 1, 0, 1, 0, 1], np.int32)
    got, got_w = _port_crop(pages, pidx, boxes, 48, 320)
    want, want_w = crop_resize_pages(jnp.asarray(pages), jnp.asarray(pidx),
                                     jnp.asarray(boxes), 48, 320)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
    np.testing.assert_array_equal(got_w, np.asarray(want_w))


def _qkv(shape_q, shape_kv, seed):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal(shape_q) * 0.5).astype(np.float32)
    k = (rng.standard_normal(shape_kv) * 0.5).astype(np.float32)
    v = rng.standard_normal(shape_kv).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize(
    "d,sq,skv,causal,ragged",
    [
        (64, 20, 20, False, False),  # the encoder's shape
        (64, 37, 37, True, False),
        (64, 20, 33, False, True),
        (128, 128, 128, False, False),  # tiles: the Pallas kernel runs
        (128, 128, 128, True, False),
        (128, 128, 128, False, True),
        (128, 45, 70, True, True),
    ],
)
def test_attention_plain_matches_reference(d, sq, skv, causal, ragged):
    """K2's plain version against ``_attention_reference`` and
    ``flash_attention(..., interpret=True)`` (which runs the Pallas
    kernel where shapes tile and the reference elsewhere), atol 1e-5."""
    b, h = 2, 2
    q, k, v = _qkv((b, h, sq, d), (b, h, skv, d), seed=d + sq + skv)
    kv_len = np.asarray([skv, max(skv // 2, 1)], np.int32) if ragged else None
    scale = 1.0 / d ** 0.5
    got = k2.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        kv_len=None if kv_len is None else torch.from_numpy(kv_len),
        causal=causal).numpy()
    jkv = None if kv_len is None else jnp.asarray(kv_len)
    want = _attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=causal, kv_len=jkv, sm_scale=scale)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
    fa = flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         kv_len=jkv, causal=causal, interpret=True)
    np.testing.assert_allclose(got, np.asarray(fa), atol=1e-5)


def test_attention_output_layout_merges_without_a_copy():
    """K2's layout contract, which the CPU version keeps as the kernel
    does: on [B,H,S,D] views of [B,S,H,D] projections it returns the
    [B,H,S,D] view of a contiguous [B,S,H,D] tensor, so ``_merge`` is a
    reshape of the same memory."""
    b, s, h, d = 2, 20, 3, 32
    q, k, v = (torch.from_numpy(a).transpose(1, 2)
               for a in _qkv((b, s, h, d), (b, s, h, d), seed=4))
    out = k2.flash_attention(q, k, v)
    assert out.shape == (b, h, s, d)
    assert not out.is_contiguous() and out.transpose(1, 2).is_contiguous()
    merged = _merge(out)
    assert merged.shape == (b, s, h * d) and merged.data_ptr() == out.data_ptr()
    want = k2.flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    torch.testing.assert_close(out, want, rtol=0, atol=0)


@pytest.mark.parametrize("causal,ragged", [(False, False), (False, True), (True, False)])
def test_self_attention_matches_flax(causal, ragged):
    """The full-sequence SelfAttention (K2's caller: projections, K2 on
    their transposed views, merge, output projection) against the flax
    module with the same weights, atol 1e-5 in float32."""
    b, s, h, dim = 3, 20, 4, 64
    x = np.random.default_rng(11).standard_normal((b, s, dim)).astype(np.float32)
    kv_len = np.asarray([20, 7, 13], np.int32) if ragged else None
    jmod = JaxSelfAttention(num_heads=h, model_dim=dim)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want, _ = jmod.apply(params, jnp.asarray(x), causal=causal,
                         kv_len=None if kv_len is None else jnp.asarray(kv_len))
    tree = jax.tree_util.tree_map(np.asarray, params)
    mod = from_flax(tree, SelfAttention(h, dim)).eval()
    with torch.no_grad():
        got = mod(torch.from_numpy(x), causal=causal,
                  kv_len=None if kv_len is None else torch.from_numpy(kv_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_cpu_wrappers_do_not_count_launches():
    before = (k1.crop_resize.launches, k2.flash_attention.launches)
    pages, pidx, boxes = _crop_case(1)
    _port_crop(pages, pidx, boxes, 16, 64)
    q, k, v = _qkv((1, 1, 4, 64), (1, 1, 4, 64), 0)
    k2.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    assert (k1.crop_resize.launches, k2.flash_attention.launches) == before
