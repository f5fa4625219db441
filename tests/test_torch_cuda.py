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
@pytest.mark.parametrize("out_hw", [(48, 320), (32, 64)])
def test_cuda_crop_kernel_matches_plain(cuda_device, out_hw):
    pages, pidx, boxes = _crop_case(5, 4, 1024, 768, 96)
    args = (torch.from_numpy(pages).to(cuda_device), torch.from_numpy(pidx).to(cuda_device),
            torch.from_numpy(boxes).to(cuda_device), *out_hw)
    before = k1.crop_resize.launches
    got, got_w = k1.crop_resize(*args)
    want, want_w = k1.crop_resize_plain(*args)
    torch.cuda.synchronize()
    assert k1.crop_resize.launches == before + 1
    assert float((got - want).abs().max()) <= 1e-5
    assert torch.equal(got_w, want_w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("d,sq,skv,causal,ragged", [
    (64, 20, 20, False, False), (32, 20, 20, False, False),
    (128, 37, 53, True, True), (64, 53, 37, True, False),
])
def test_cuda_attention_kernel_matches_plain(cuda_device, dtype, atol, d, sq, skv,
                                             causal, ragged):
    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn(16, 6, s, d, device=cuda_device, generator=g).to(dtype)
               for s in (sq, skv, skv))
    kv_len = (torch.arange(16, device=cuda_device, dtype=torch.int32) % skv + 1
              if ragged else None)
    before = k2.flash_attention.launches
    got = k2.flash_attention(q, k, v, kv_len=kv_len, causal=causal)
    want = k2.attention_reference(q, k, v, causal=causal, kv_len=kv_len,
                                  sm_scale=1.0 / d ** 0.5)
    torch.cuda.synchronize()
    assert k2.flash_attention.launches == before + 1
    assert float((got.float() - want.float()).abs().max()) <= atol


@pytest.mark.cuda
def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    q = torch.zeros(1, 1, 4, 48, device=cuda_device)
    with pytest.raises(ValueError):
        k2.flash_attention(q, q, q)  # head width 48
    with pytest.raises(ValueError):
        k1.crop_resize(torch.zeros(1, 8, 8, device=cuda_device),  # not uint8
                       torch.zeros(1, dtype=torch.int32, device=cuda_device),
                       torch.zeros(1, 4, device=cuda_device), 4, 4)
