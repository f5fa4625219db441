"""The port's host-side copies (box organisation, line grouping, the page
result schema, the upload packers), its bf16 CRAFT and its float32
precision context, against the JAX package on the same seeded inputs."""

import contextlib
import ctypes
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from marie_tpu.boxes import line_processor as jlines
from marie_tpu.boxes.box_processor import BoxProcessor as JaxBoxProcessor
from marie_tpu.boxes.box_processor import estimate_character_width as jax_char_width
from marie_tpu.boxes.craft_box_processor import BoxProcessorCraft as JaxBoxProcessorCraft
from marie_tpu.document.ocr_processor import assemble_page_result as jax_assemble
from marie_tpu.enums import CoordinateFormat as JaxCoordinateFormat
from marie_tpu.enums import PSMode as JaxPSMode
from marie_tpu.models import configs as jcfg
from marie_tpu.preprocess.ops import normalize_page as jax_normalize_page
from marie_tpu.utils import pack4 as jpack
from marie_tpu_torch.boxes import line_processor as tlines
from marie_tpu_torch.boxes.box_processor import BoxProcessor, estimate_character_width
from marie_tpu_torch.boxes.craft_box_processor import BoxProcessorCraft
from marie_tpu_torch.document.ocr_processor import assemble_page_result
from marie_tpu_torch.enums import CoordinateFormat, PSMode
from marie_tpu_torch.models import configs as tcfg
from marie_tpu_torch.registry.convert import init_flax_layout
from marie_tpu_torch.utils import pack4 as tpack
from marie_tpu_torch.utils.device import _precision_flags, float32_precision


def _word_boxes(seed, n=40, h=400, w=300):
    """Float xywh word boxes on a few text lines, some overlapping two
    lines, plus scores."""
    rng = np.random.default_rng(seed)
    line_y = np.sort(rng.uniform(0, h - 30, max(n // 6, 1)))
    y = rng.choice(line_y, n) + rng.normal(0, 3, n)
    boxes = np.stack([rng.uniform(0, w - 40, n), np.clip(y, 0, h - 25),
                      rng.uniform(5, 60, n), rng.uniform(8, 24, n)], -1)
    boxes[: n // 8, 3] *= 3  # tall boxes that span lines
    return boxes, rng.uniform(0, 1, n).astype(np.float32)


def _assert_tuple_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n", [0, 1, 40, 150])
@pytest.mark.parametrize("mode", ["sparse", "line", "raw_line", "word", "multiline"])
@pytest.mark.parametrize("return_order", [False, True])
def test_organize_boxes_matches_jax(mode, n, return_order):
    boxes, scores = _word_boxes(n + 3, max(n, 1))
    boxes, scores = boxes[:n], scores[:n]
    got = BoxProcessor.organize_boxes(boxes, scores, (400, 300), PSMode(mode),
                                      return_order=return_order)
    want = JaxBoxProcessor.organize_boxes(boxes, scores, (400, 300), JaxPSMode(mode),
                                          return_order=return_order)
    _assert_tuple_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_line_grouping_matches_jax(seed):
    boxes, _ = _word_boxes(seed, 60)
    lines = tlines.line_merge(None, boxes)
    assert lines == jlines.line_merge(None, boxes) and len(lines) > 1
    np.testing.assert_array_equal(tlines.assign_line_numbers(lines, boxes),
                                  jlines.assign_line_numbers(lines, boxes))
    for box in boxes[:10]:
        assert tlines.find_line_number(lines, box) == jlines.find_line_number(lines, box)
    far = np.asarray([0.0, 1e4, 5.0, 5.0])  # overlaps no line: nearest bottom
    assert tlines.find_line_number(lines, far) == jlines.find_line_number(lines, far)
    assert tlines.assign_line_numbers([], boxes).tolist() == [-1] * len(boxes)


def test_assemble_page_result_matches_jax():
    """Result dicts equal, with confidences on the halfway cases of the
    3-decimal rounding and extra per-word keys carried through."""
    boxes, _ = _word_boxes(5, 30)
    boxes_int, _, lines, _ = JaxBoxProcessor.organize_boxes(
        boxes, np.ones(30, np.float32), (400, 300))
    rng = np.random.default_rng(6)
    conf = [0.0005, 0.0015, 0.1235, 0.9995, 1.0] + rng.uniform(0, 1, 25).tolist()
    results = [{"text": f"w{i}", "confidence": c, "tag": i} for i, c in enumerate(conf)]
    got = assemble_page_result((400, 300), boxes_int, lines, results)
    assert got == jax_assemble((400, 300), boxes_int, lines, results)
    assert len(got["lines"]) > 1
    assert assemble_page_result((4, 5), [], [], []) == jax_assemble((4, 5), [], [], [])


def test_estimate_character_width_and_enums_match_jax():
    boxes, _ = _word_boxes(7, 10)
    texts = ["ab", "", "word", "x", "longer", "a", "bb", "ccc", "d", "ee"]
    assert estimate_character_width(boxes, texts) == jax_char_width(boxes, texts)
    assert estimate_character_width(boxes, [""] * 10) == jax_char_width(boxes, [""] * 10)
    assert [m.value for m in PSMode] == [m.value for m in JaxPSMode]
    assert PSMode.from_value("LINE") is PSMode.LINE and PSMode.from_value(None) is PSMode.SPARSE
    for box in ([1, 2, 3, 4], [5, 6, 9, 12]):
        for a, b in ((CoordinateFormat.XYWH, CoordinateFormat.XYXY),
                     (CoordinateFormat.XYXY, CoordinateFormat.XYWH)):
            assert CoordinateFormat.convert(box, a, b) == JaxCoordinateFormat.convert(
                box, JaxCoordinateFormat(a.value), JaxCoordinateFormat(b.value))


def _pages(seed, shape=(3, 24, 64)):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("fmt", ["u4", "u2", "u1", "u1d"])
def test_packers_match_jax(fmt):
    """Each packer's numpy version equals the JAX package's packer, the
    native one where it builds (as it does here), byte for byte; each
    host unpacker equals the JAX one."""
    pages = _pages(3)
    packer, bits = tpack.PACKERS[fmt]
    got = packer(pages)
    want = {"u4": jpack.pack4, "u2": jpack.pack2, "u1": jpack.pack1,
            "u1d": jpack.pack1d}[fmt](pages)
    assert got.dtype == np.uint8 and got.shape == pages.shape[:-1] + (64 * bits // 8,)
    np.testing.assert_array_equal(got, want)
    lib = jpack._load()
    native = np.empty_like(got)
    ptr = ctypes.c_void_p
    if fmt == "u1d":
        lib.pack1d(pages.ctypes.data_as(ptr), native.ctypes.data_as(ptr), 3, 24, 64)
    else:
        getattr(lib, {"u4": "pack4", "u2": "pack2", "u1": "pack1"}[fmt])(
            pages.ctypes.data_as(ptr), native.ctypes.data_as(ptr), native.size)
    np.testing.assert_array_equal(got, native)
    unpack_t = {4: tpack.unpack4_host, 2: tpack.unpack2_host, 1: tpack.unpack1_host}[bits]
    unpack_j = {4: jpack.unpack4_host, 2: jpack.unpack2_host, 1: jpack.unpack1_host}[bits]
    np.testing.assert_array_equal(unpack_t(got), unpack_j(got))


def test_packers_refuse_widths_they_cannot_pack():
    for packer, width in ((tpack.pack4, 63), (tpack.pack2, 62), (tpack.pack1, 60),
                          (tpack.pack1d, 60)):
        with pytest.raises(ValueError):
            packer(_pages(0, (1, 4, width)))


# Measured on these inputs: max |port - JAX| of the bf16 heatmap is
# 0.0038760 (fast_s2d2) and 0.0021412 (tiny), under one bf16 ulp of a
# value in [0.5, 1) (the random-weight map lies in [0.46, 0.53]), on 2.2%
# and 1.5% of the values: both sides round at the same points (XLA's CPU
# rounding, models/craft.py), and the convolutions sum in another order
# (Eigen's against oneDNN's).  float32 agrees to 1.2e-7.
_HEAT_ATOL = {"float32": 2e-7, "bfloat16": 2.0 ** -8}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,hw", [("tiny", (64, 96)), ("fast_s2d2", (128, 192))])
def test_craft_heatmap_in_param_dtype_matches_jax(name, hw, dtype):
    tree = init_flax_layout(getattr(tcfg.CraftConfig, name)(), 3)
    pages = _pages(4, (2, *hw))
    jbp = JaxBoxProcessorCraft(config=getattr(jcfg.CraftConfig, name)(),
                               variables=jax.tree_util.tree_map(jnp.asarray, tree),
                               param_dtype=dtype)
    vdt = jax.tree_util.tree_leaves(jbp.variables)[0].dtype
    rgb = jax.vmap(jax_normalize_page)(jnp.repeat(jnp.asarray(pages)[..., None], 3, -1))
    # jitted, as the JAX engine's detect program runs it: XLA keeps the
    # sigmoid's last division in float32 under jit, and eager dispatch
    # would round it to bf16
    forward = jax.jit(lambda v, x: jbp.model.apply(v, x.astype(vdt)).astype(jnp.float32))
    want = np.asarray(forward(jbp.variables, rgb))
    bp = BoxProcessorCraft(getattr(tcfg.CraftConfig, name)(), tree, param_dtype=dtype,
                           device="cpu")
    assert next(bp.model.parameters()).dtype == (
        torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    assert all(b.dtype == next(bp.model.parameters()).dtype
               for n, b in bp.model.named_buffers() if "running" in n)
    got = bp.heatmap(pages)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=_HEAT_ATOL[dtype])


def _flags():
    return _precision_flags()[0]()


def test_precision_context_restores_the_flags_it_found():
    """Inside a block the flags read as asked; after it (also after an
    error inside it, and with the flags set by torch's legacy switches)
    they read as before; the legacy switches stay readable."""
    start = _flags()
    matmul_precision = torch.get_float32_matmul_precision()
    try:
        for on in (True, False):
            torch.backends.cudnn.allow_tf32 = on
            torch.backends.cuda.matmul.allow_tf32 = on
            before = _flags()
            with float32_precision():
                assert set(_flags()) == {"ieee"}
                with float32_precision(allow_tf32=False):
                    assert set(_flags()) == {"ieee"}
                assert set(_flags()) == {"ieee"}
            assert _flags() == before
            with float32_precision(allow_tf32=True):
                assert set(_flags()) == {"tf32"}
            assert _flags() == before
            with pytest.raises(ZeroDivisionError), float32_precision():
                1 / 0
            assert _flags() == before
            assert torch.backends.cudnn.allow_tf32 is on
            assert torch.backends.cuda.matmul.allow_tf32 is on
            with float32_precision(), pytest.raises(RuntimeError):
                with float32_precision(allow_tf32=True):
                    pass
            assert _flags() == before
    finally:
        torch.set_float32_matmul_precision(matmul_precision)
        _precision_flags()[1](start)
    assert _flags() == start


def test_precision_context_is_shared_across_threads():
    """Blocks on many threads at once, of one mode or the other, never
    see the other mode's flags and leave the flags as they found them."""
    import sys

    before = _flags()
    errors = []
    barrier = threading.Barrier(8)

    def work(i):
        mode = i % 2 == 0
        want = {"tf32" if mode else "ieee"}
        barrier.wait()
        for _ in range(200):
            with float32_precision(allow_tf32=mode):
                time.sleep(0)  # let the other threads run inside the block
                if set(_flags()) != want:
                    errors.append((i, _flags()))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert errors == []
    assert _flags() == before


def test_cudnn_benchmark_restores_the_flags_and_own_thread_reraises():
    """``cudnn_benchmark`` sets the benchmark flag and its limit inside the
    block and restores both after it, also after an error;
    ``on_own_thread`` returns ``fn``'s value from another thread and
    re-raises its exception on the caller's."""
    from marie_tpu_torch.utils.device import (CUDNN_BENCHMARK_LIMIT, cudnn_benchmark,
                                              on_own_thread)

    cudnn = torch.backends.cudnn
    before = cudnn.benchmark, cudnn.benchmark_limit
    with pytest.raises(ValueError):
        with cudnn_benchmark():
            assert (cudnn.benchmark, cudnn.benchmark_limit) == (True, CUDNN_BENCHMARK_LIMIT)
            raise ValueError("inside")
    assert (cudnn.benchmark, cudnn.benchmark_limit) == before
    caller = threading.get_ident()
    assert on_own_thread(threading.get_ident) != caller

    def fail():
        raise KeyError("on the worker")

    with pytest.raises(KeyError, match="on the worker"):
        on_own_thread(fail)


def _old_cudnn_benchmark():
    """The save-and-restore-per-block ``cudnn_benchmark`` this module had
    before it shared one hold: planted to show the crossed-threads test
    fails it."""
    from marie_tpu_torch.utils.device import CUDNN_BENCHMARK_LIMIT

    @contextlib.contextmanager
    def block():
        cudnn = torch.backends.cudnn
        saved = cudnn.benchmark, cudnn.benchmark_limit
        cudnn.benchmark, cudnn.benchmark_limit = True, CUDNN_BENCHMARK_LIMIT
        try:
            yield
        finally:
            cudnn.benchmark, cudnn.benchmark_limit = saved

    return block()


def _crossed_blocks(hold):
    """Two threads enter ``hold()`` blocks A then B and leave A then B
    (crossed); a third block nests in B.  Returns (the flags B read after
    A left, the flags after both), the flags reset to what they were."""
    cudnn = torch.backends.cudnn
    a_in, b_in, a_out = threading.Event(), threading.Event(), threading.Event()
    seen = {}

    def a():
        with hold():
            a_in.set()
            b_in.wait(10)
        a_out.set()

    def b():
        a_in.wait(10)
        with hold():
            b_in.set()
            a_out.wait(10)
            seen["b_after_a"] = cudnn.benchmark, cudnn.benchmark_limit
            with hold():
                pass

    threads = [threading.Thread(target=a), threading.Thread(target=b)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    return seen["b_after_a"], (cudnn.benchmark, cudnn.benchmark_limit)


def test_cudnn_benchmark_is_one_hold_across_crossed_threads():
    """Blocks on two threads that enter and leave in crossed order (and a
    block nested in the second) share one hold: the second still holds
    the flags after the first left, and the flags end as they began.
    The old per-block save and restore fails both."""
    from marie_tpu_torch.utils.device import CUDNN_BENCHMARK_LIMIT, cudnn_benchmark

    cudnn = torch.backends.cudnn
    start = cudnn.benchmark, cudnn.benchmark_limit
    held = (True, CUDNN_BENCHMARK_LIMIT)
    try:
        cudnn.benchmark, cudnn.benchmark_limit = False, 7
        inside, after = _crossed_blocks(cudnn_benchmark)
        assert inside == held
        assert after == (False, 7)
        inside, after = _crossed_blocks(_old_cudnn_benchmark)
        assert inside == (False, 7) and after == held  # the old code's two faults
    finally:
        cudnn.benchmark, cudnn.benchmark_limit = start


def test_launch_counts_by_path_lose_no_update_across_threads():
    """Kernel launch counts from many threads at once, on two paths and
    outside one, add up (the engine launches from its upload worker and
    from the collect)."""
    import sys

    from marie_tpu_torch.ops.kernels import _build

    def wrapper():
        pass

    _build.reset_counts(wrapper)
    barrier = threading.Barrier(16)

    def work(i):
        barrier.wait()
        if i % 4 == 3:
            for _ in range(500):
                _build.count_launch(wrapper)
            return
        with _build.launch_path("fused" if i % 2 else "overflow"):
            for _ in range(500):
                _build.count_launch(wrapper)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert wrapper.launches == 16 * 500
    assert wrapper.launches_by_path == {"fused": 2000, "overflow": 4000, "other": 2000}
