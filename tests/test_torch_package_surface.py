"""The port's package surface against the JAX package's: every name of the
``__all__`` of ``ocr``, ``ops``, ``preprocess``, ``components``, ``models``,
``document`` and ``registry`` is on the port's package (``WAITING`` would
list, by name, any whose module is not ported yet: none is), the engines'
common base ``OcrEngine``, and the page functions ``crop_resize``,
``resize_page`` and ``prepare_page`` against JAX on the CPU.

Limits: ``crop_resize`` and ``prepare_page`` equal to the bit (both copy
XLA's CPU rounding); ``resize_page`` within RESIZE_LIMIT of the page's
range (its weight matrices may differ from JAX's constant-folded ones by an
ulp, and the products sum in another order).
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from marie_tpu.preprocess import ops as jops
from marie_tpu_torch.preprocess import ops as tops

PACKAGES = ("ocr", "ops", "preprocess", "components", "models", "document", "registry")
#: names of the JAX ``__all__`` whose modules are not ported yet (none)
WAITING = {}
RESIZE_LIMIT = 2e-6  # of the page's largest value


@pytest.mark.parametrize("package", PACKAGES)
def test_port_package_exports_the_jax_names(package):
    jax_pkg = importlib.import_module(f"marie_tpu.{package}")
    port = importlib.import_module(f"marie_tpu_torch.{package}")
    waiting = WAITING.get(package, ())
    assert set(waiting) <= set(jax_pkg.__all__)
    for name in jax_pkg.__all__:
        if name in waiting:
            assert not hasattr(port, name), f"{name} is ported: take it off the waiting list"
        else:
            assert hasattr(port, name), (package, name)
    assert port.__all__ == [n for n in jax_pkg.__all__ if n not in waiting]


def test_ocr_engine_is_the_base_of_every_engine():
    from marie_tpu_torch.ocr import (
        DefaultOcrEngine,
        MockOcrEngine,
        OcrEngine,
        VotingOcrEngine,
    )
    from marie_tpu_torch.ocr.ocr_engine import PipelineOcrEngine

    for engine in (PipelineOcrEngine, MockOcrEngine, DefaultOcrEngine, VotingOcrEngine):
        assert issubclass(engine, OcrEngine), engine
    with pytest.raises(TypeError):
        OcrEngine()  # extract is abstract
    mock = MockOcrEngine()
    assert mock.logger is not None
    assert len(mock.extract([np.full((40, 60), 255, np.uint8)])[0]["words"]) == 4


def _page_and_boxes(seed, h=90, w=140, n=12):
    rng = np.random.default_rng(seed)
    page = rng.uniform(0.0, 1.0, (h, w, 3)).astype(np.float32)
    x0 = rng.uniform(-5, w - 10, n)
    y0 = rng.uniform(-5, h - 8, n)
    boxes = np.stack([x0, y0, x0 + rng.uniform(0.5, 90, n), y0 + rng.uniform(0.5, 30, n)], 1)
    return page, boxes.astype(np.float32)


@pytest.mark.parametrize("preserve_aspect", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_crop_resize_matches_jax(seed, preserve_aspect):
    page, boxes = _page_and_boxes(seed)
    # the JAX function takes preserve_aspect as a traced argument: only its
    # default compiles, so the test compiles it with the flag static
    crop = jax.jit(jops.crop_resize.__wrapped__,
                   static_argnames=("out_h", "out_w", "preserve_aspect"))
    want, want_w = crop(jnp.asarray(page), jnp.asarray(boxes), 24, 96, preserve_aspect)
    got, got_w = tops.crop_resize(page, boxes, 24, 96, preserve_aspect, device="cpu")
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("src,dst", [((90, 140), (45, 70)), ((90, 140), (61, 37)),
                                     ((90, 140), (200, 300)), ((90, 140), (90, 200)),
                                     ((64, 48), (64, 48))])
def test_resize_page_matches_jax(src, dst):
    rng = np.random.default_rng(sum(src) + sum(dst))
    page = rng.uniform(0, 255, (*src, 3)).astype(np.float32)
    want = np.asarray(jops.resize_page(jnp.asarray(page), *dst))
    got = tops.resize_page(page, *dst, device="cpu").numpy()
    assert got.shape == want.shape == (*dst, 3)
    err = np.abs(got - want).max() / np.abs(want).max()
    print(src, dst, err)
    assert err <= RESIZE_LIMIT


@pytest.mark.parametrize("seed", [0, 1])
def test_prepare_page_matches_jax(seed):
    rng = np.random.default_rng(seed)
    page = rng.integers(0, 256, (64, 96, 3), dtype=np.uint8)
    page[10:30, 20:70] = rng.integers(0, 60, (20, 50, 3))  # ink
    want = jops.prepare_page(jnp.asarray(page), 64, 96)
    got = tops.prepare_page(page, 64, 96, device="cpu")
    assert set(got) == set(want) == {"rgb", "gray", "ink"}
    for key in ("rgb", "gray", "ink"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
