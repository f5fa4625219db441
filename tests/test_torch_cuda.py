"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test is marked ``cuda`` and skips without a CUDA device.

This module imports nothing of JAX, so it also runs on a machine without
it, with the JAX-side ``conftest.py`` left out:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from marie_tpu_torch.ops.kernels import crop_resize as k1
from marie_tpu_torch.ops.kernels import flash_attention as k2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels build with nvcc on the card")
    from marie_tpu_torch.utils.device import set_parity_precision

    set_parity_precision()
    return torch.device("cuda")


def _crop_case(seed, p, h, w, n):
    rng = np.random.default_rng(seed)
    pages = rng.integers(0, 255, (p, h, w), dtype=np.uint8)
    x0 = rng.uniform(-10, w - 40, n)
    y0 = rng.uniform(-10, h - 30, n)
    boxes = np.stack([x0, y0, x0 + rng.uniform(1, 400, n),
                      y0 + rng.uniform(1, 400, n)], axis=-1)
    boxes = np.clip(boxes, 0, [w, h, w, h]).astype(np.float32)
    return pages, rng.integers(0, p, n).astype(np.int32), boxes


@pytest.mark.cuda
@pytest.mark.parametrize("n", [96, 1, 1062])
@pytest.mark.parametrize("out_hw", [(48, 320), (32, 64), (48, 321), (20, 77)])
def test_cuda_crop_kernel_matches_plain(cuda_device, out_hw, n):
    """Bit-identical (limit 0) at the slice's width, a narrow one and two
    widths that are not a multiple of 4 (the kernel's scalar stores), for
    one crop, a batch and the ink run's 1,062 overflow crops."""
    pages, pidx, boxes = _crop_case(5, 4, 1024, 768, n)
    args = (torch.from_numpy(pages).to(cuda_device), torch.from_numpy(pidx).to(cuda_device),
            torch.from_numpy(boxes).to(cuda_device), *out_hw)
    before = k1.crop_resize.launches
    got, got_w = k1.crop_resize(*args)
    want, want_w = k1.crop_resize_plain(*args)
    torch.cuda.synchronize()
    assert k1.crop_resize.launches == before + 1
    assert torch.equal(got, want)
    assert torch.equal(got_w, want_w)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "projections"])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("d,h,sq,skv,causal,ragged", [
    (64, 6, 20, 20, False, False),  # the encoder's shape
    (32, 6, 20, 20, False, False),
    (128, 6, 37, 53, True, True),
    (64, 6, 53, 37, True, False),  # Sq > Skv: the first 16 rows fully masked
    (64, 6, 45, 150, False, True),  # Skv > 64: the online-rescale loop
    (128, 4, 80, 130, True, True),  # two Q chunks and three key tiles
    (64, 12, 20, 20, False, True),  # H > 8: heads split over two blocks
    (32, 12, 9, 70, True, False),
])
def test_cuda_attention_kernel_matches_plain(cuda_device, dtype, atol, d, h, sq, skv,
                                             causal, ragged, layout):
    """fp32 within 1e-4 (summation order), bf16 within 2e-2 (one bf16
    rounding of the output); "projections" feeds the [B,H,S,D] transposes
    of [B,S,H,D] tensors, as the encoder does, which the kernel reads in
    place."""
    g = torch.Generator(device="cuda").manual_seed(1)
    b = 16

    def make(s):
        x = torch.randn(b, s, h, d, device=cuda_device, generator=g).to(dtype)
        return x.transpose(1, 2) if layout == "projections" else x.transpose(1, 2).contiguous()

    q, k, v = make(sq), make(skv), make(skv)
    kv_len = (torch.arange(b, device=cuda_device, dtype=torch.int32) % skv + 1
              if ragged else None)
    before = k2.flash_attention.launches
    got = k2.flash_attention(q, k, v, kv_len=kv_len, causal=causal)
    want = k2.attention_reference(q, k, v, causal=causal, kv_len=kv_len,
                                  sm_scale=1.0 / d ** 0.5)
    torch.cuda.synchronize()
    assert k2.flash_attention.launches == before + 1
    assert got.shape == (b, h, sq, d) and got.transpose(1, 2).is_contiguous()
    assert float((got.float() - want.float()).abs().max()) <= atol


@pytest.mark.cuda
def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    q = torch.zeros(1, 1, 4, 48, device=cuda_device)
    with pytest.raises(ValueError):
        k2.flash_attention(q, q, q)  # head width 48
    x = torch.zeros(1, 1, 4, 128, device=cuda_device)
    with pytest.raises(ValueError):
        k2.flash_attention(*(x[..., ::2],) * 3)  # last dimension strided
    with pytest.raises(ValueError):
        k1.crop_resize(torch.zeros(1, 8, 8, device=cuda_device),  # not uint8
                       torch.zeros(1, dtype=torch.int32, device=cuda_device),
                       torch.zeros(1, 4, device=cuda_device), 4, 4)
