#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``marie_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``marie_tpu_torch/csrc`` with nvcc and holds
each against its plain PyTorch version at the shapes of the main path
(``k1``, ``k2``); checks the engine on a small input against the plain
CPU path (``small_reference``) and the detector's float32 precision
against torch's global TF32 switches (``precision``); runs the serving
engine (``PipelineOcrEngine.extract`` over ``BoxProcessorCraft`` and
``TrOcrProcessor``) in the JAX serving configuration at the models' full
widths, with random weights from a seed, on 16 numpy-drawn 1024x768 pages
(``slice``) and streams 48 pages through it (``stream``); checks the
engine with chained LayoutLM heads on a small input against the CPU
(``chain_reference``), runs it on the 16 pages with the heads at the JAX
chain width (``chain``), and runs the LayoutLM classifier, indexer and
splitter at LayoutLMv3-base width, card against CPU
(``layoutlm_base``); builds the serving engine with the chained heads
from the trained trees of ``torch_zoo/`` and runs the 16 shipped pages,
against their truth and the JAX engine's golden (``trained``); runs an
RGB page, a page over the largest bucket, a region request and the
RAW_LINE, WORD and MULTI_LINE modes on the card against the CPU path and
the golden (``forms``); runs the registry's ``best`` engine (CRAFT and a
word-level vote of TrOCR beam-5 and the CRNN) on the shipped pages
against the truth, its JAX golden and the CPU path (``best``); traces
one more run per box source, of the chained engine, of the trained
engine and of the ``best`` engine, with torch.profiler (``profile``).  It prints one JSON
line per phase; the last two lines are the kernel table and
``{"ok": true, "device": {...}}``.  Every phase raises on failure; the
script exits nonzero, with no result line, without a CUDA device or
without the package beside it.  It imports nothing of JAX.
"""

import json
import os
import statistics
import sys
import time

SEED = 0
SLICE_PAGES = 16  # one page group of the serving engine
H100_BYTES_PER_S = 3.35e12  # HBM3, SXM data sheet
# dense tensor bf16; float32 outside the tensor cores (SIMT); float32
# products as three TF32 products (3xTF32) on the dense TF32 tensor rate
H100_FLOPS = {"bf16": 989e12, "fp32": 67e12, "3xtf32": 495e12 / 3}

K1_LIMIT = 0.0  # bit-identical: the kernel does the plain version's float32 ops
K2_LIMITS = {"fp32": 1e-4, "bf16": 2e-2}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def device_ms(fn, reps: int = 25) -> float:
    """Median device time of one call of ``fn``, warm (its inputs stay in
    the 50 MB L2 from the call before): the stream is kept busy with a
    sleep kernel while the events and the call are enqueued, so the
    host's launch overhead stays out of the measurement."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def cold_device_ms(fn, copies: int, rounds: int = 3) -> float:
    """Device time per call with cold inputs: ``fn(i)`` runs on copy ``i``
    of the inputs, and one run of ``copies * rounds`` back-to-back calls
    rotates over copies that hold more than the 50 MB L2, so each call
    finds its inputs in device memory.  Every call's output is kept, so
    each writes fresh memory.  Events bracket the whole run (after a sleep
    kernel long enough to cover the host's enqueue) and the time is
    divided by the count."""
    import torch

    count = copies * rounds
    for _ in range(2):  # warm-up; grows the allocator's pool to the run's size
        t0 = time.perf_counter()
        outs = [fn(i % copies) for i in range(count)]
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        del outs
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(host_s * 3e9) + 1_000_000)  # >= host_s at <= 2 GHz
    start.record()
    outs = [fn(i % copies) for i in range(count)]
    end.record()
    end.synchronize()
    del outs
    return start.elapsed_time(end) / count


def n_copies(nbytes: int) -> int:
    """Copies of ``nbytes`` of inputs and outputs that hold over 100 MB,
    twice the H100's 50 MB L2."""
    return max(2, -(-100_000_000 // nbytes))


def timed(fn, copies: int) -> dict:
    """{"cold": ms, "warm": ms} of ``fn(i)`` (see cold_device_ms)."""
    return {"cold": cold_device_ms(fn, copies), "warm": device_ms(lambda: fn(0))}


def draw_pages(n: int, h: int, w: int, seed: int):
    """White pages with lines of word-shaped ink blocks: each word is a run
    of glyph strokes of random darkness, ~20 px tall."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pages = np.full((n, h, w), 255, np.uint8)
    for page in pages:
        y = int(rng.integers(30, 60))
        while y < h - 40:
            x = int(rng.integers(20, 60))
            th = int(rng.integers(14, 24))
            while x < w - 80:
                ww = int(rng.integers(24, 120))
                level = int(rng.integers(0, 90))
                for gx in range(x, x + ww, int(rng.integers(5, 9))):
                    gw = int(rng.integers(2, 5))
                    top = y + int(rng.integers(0, 4))
                    page[top:y + th, gx:gx + gw] = level
                page[y + th // 2:y + th // 2 + 2, x:x + ww] = level
                x += ww + int(rng.integers(12, 28))
            y += th + int(rng.integers(14, 30))
    return pages


def phase_device():
    import torch

    from marie_tpu_torch.ops.kernels import _build
    from marie_tpu_torch.utils.device import card_name_and_power_limit, set_parity_precision

    set_parity_precision()
    t0 = time.perf_counter()
    built = _build.build_all()
    build_s = time.perf_counter() - t0
    card = card_name_and_power_limit()
    if card is None:
        raise RuntimeError("nvidia-smi did not report the card")
    emit({"phase": "device", "card": card, "ptxas": _build.PTXAS,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": round(build_s, 3),
          "built": {k: round(v, 3) for k, v in built.items()}})
    return card


def k1_source_pixels(boxes, page_of, page_shape, oh, ow):
    """(page pixels K1's bilinear taps reach, output pixels it samples)
    for these boxes: each box reads the rows of its out_h row taps times
    the columns of its eff_w column taps, counted once per page.  The
    arithmetic is the kernel's, in float32."""
    import numpy as np

    p, h, w = page_shape
    f = np.float32
    touched = np.zeros(page_shape, bool)
    sampled = 0
    for (x0, y0, x1, y1), pg in zip(boxes.astype(f), page_of):
        bh, bw = max(y1 - y0, f(1)), max(x1 - x0, f(1))
        eff_w = int(min(np.rint(bw * (f(oh) / bh)), ow))
        step = max(bh * f(1.0 / oh), bw * f(1.0 / ow))
        sy = np.clip((np.arange(oh, dtype=f) + f(0.5)) * f(1.0 / oh) * bh + y0 - f(0.5), 0, h - 1)
        sx = np.clip((np.arange(eff_w, dtype=f) + f(0.5)) * step + x0 - f(0.5), 0, w - 1)
        ys, xs = np.floor(sy).astype(int), np.floor(sx).astype(int)
        rows = np.union1d(ys, np.minimum(ys + 1, h - 1))
        cols = np.union1d(xs, np.minimum(xs + 1, w - 1))
        touched[min(max(int(pg), 0), p - 1)][np.ix_(rows, cols)] = True
        sampled += oh * eff_w
    return int(touched.sum()), sampled


def phase_k1(p: int = 8, n: int = 256, case: str = "batch_256", out_hw=(48, 320),
             channel_mean: bool = False):
    """K1 on ``p`` pages of the 1024x768 bucket and ``n`` crops of
    ``out_hw`` (TrOCR's 48x320: the serving slice's fused batch is 16
    pages and 2,560 crops; the CRNN's 32x256 with the channel mean, one
    page and a 128-crop chunk in the ``best`` engine), with boxes taller
    than the TPU kernel's 192-row window and boxes clipped at the page
    edges."""
    import numpy as np
    import torch

    from marie_tpu_torch.ops.kernels.crop_resize import crop_resize, crop_resize_plain

    dev = torch.device("cuda")
    (h, w), (oh, ow) = (1024, 768), out_hw
    rng = np.random.default_rng(SEED + 1)
    pages = torch.from_numpy(draw_pages(p, h, w, SEED + 2)).to(dev)
    x0 = rng.uniform(-20, w - 40, n)
    y0 = rng.uniform(-10, h - 30, n)
    bw = rng.uniform(8, 400, n)
    bh = rng.uniform(6, 60, n)
    bh[:16] = rng.uniform(200, 700, 16)  # taller than the 192-row window
    boxes = np.stack([x0, y0, x0 + bw, y0 + bh], -1)
    boxes[16:24, 2] = w  # right edge
    boxes[24:32, 3] = h  # bottom edge
    boxes[32:40, :2] = 0.0  # top-left corner
    boxes = np.clip(boxes, 0, [w, h, w, h]).astype(np.float32)
    boxes_t = torch.from_numpy(boxes).to(dev)
    page_of = torch.from_numpy(rng.integers(0, p, n).astype(np.int32)).to(dev)

    # the keyword only where set, so that scripts/kernel_times.py can time
    # a tree whose K1 lacks it
    mean = {"channel_mean": True} if channel_mean else {}
    got, got_w = crop_resize(pages, page_of, boxes_t, oh, ow, **mean)
    want, want_w = crop_resize_plain(pages, page_of, boxes_t, oh, ow, **mean)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not (err <= K1_LIMIT and torch.equal(got_w, want_w)):
        raise AssertionError(f"K1 disagrees with its plain version: max abs err "
                             f"{err}, eff_w equal {torch.equal(got_w, want_w)}")
    copies = n_copies(pages.numel() + n * oh * ow * 4)
    ins = [(pages.clone(), page_of.clone(), boxes_t.clone()) for _ in range(copies)]
    t_kernel = timed(lambda i: crop_resize(*ins[i], oh, ow, **mean), copies)
    t_plain = timed(lambda i: crop_resize_plain(*ins[i], oh, ow, **mean), copies)
    del ins
    page_bytes, sampled = k1_source_pixels(boxes, page_of.cpu().numpy(), (p, h, w), oh, ow)
    nbytes = (page_bytes + page_of.numel() * 4 + boxes_t.numel() * 4
              + n * oh * ow * 4 + n * 4)
    # per sampled output pixel: 5 fma (2 flops each), 5 mul, 8 add/sub;
    # the channel mean adds 2 fma and a mul
    flops = sampled * (28 if channel_mean else 23)
    bound_bytes = nbytes / H100_BYTES_PER_S * 1e3
    bound_ops = flops / H100_FLOPS["fp32"] * 1e3
    row = {"name": "crop_resize", "route": "cuda",
           "source": "marie_tpu_torch/csrc/crop_resize.cu",
           "replaces": "marie_tpu/ops/pallas/crop_resize.py:140",
           "max_abs_err": err, "ms": t_kernel["cold"], "plain_ms": t_plain["cold"],
           "bound_ms": max(bound_bytes, bound_ops),
           "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
           "library_ms": None}
    emit({"phase": "k1", "case": case, "shape": [p, h, w, n, oh, ow],
          "channel_mean": channel_mean, "limit": K1_LIMIT,
          "tall_boxes": 16, "edge_boxes": 24, "copies": copies,
          "warm_ms": t_kernel["warm"], "plain_warm_ms": t_plain["warm"], **row})
    return row


def _attn_inputs(b, h, sq, skv, d, dtype, seed, projections):
    """q [B,H,Sq,D], k and v [B,H,Skv,D]; with ``projections`` each is the
    transposed view of a [B,S,H,D] tensor, as SelfAttention passes them."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def make(s):
        x = torch.randn(b, s, h, d, device="cuda", generator=g).to(dtype).transpose(1, 2)
        return x if projections else x.contiguous()

    return make(sq), make(skv), make(skv)


def _sdpa_mask(b, sq, skv, kv_len, causal):
    """The boolean ``attn_mask`` [B, 1, Sq, Skv] (True: attend) that gives
    SDPA K2's masks: keys below ``kv_len`` and, with ``causal``, the
    bottom-right aligned causal band."""
    import torch

    keys = torch.arange(skv, device="cuda")
    mask = torch.ones(b, 1, sq, skv, dtype=torch.bool, device="cuda")
    if kv_len is not None:
        mask &= (keys < kv_len[:, None, None, None])
    if causal:
        mask &= (torch.arange(sq, device="cuda")[:, None] >= keys[None, :] - (skv - sq))
    return mask


#: K2 cases: (name, (B, H, Sq, Skv, D), dtype, causal, kv_len (None: no
#: kv_len mask; an int: the least of a uniform draw up to Skv; INDEXER:
#: the windows the indexer builds), q/k/v as the projections' views)
INDEXER = "indexer windows"
K2_CASES = [
    ("encoder_bf16", (256, 6, 20, 20, 64), "bf16", False, None, False),
    ("encoder_bf16_strided", (256, 6, 20, 20, 64), "bf16", False, None, True),
    ("encoder_bf16_serving", (2560, 6, 20, 20, 64), "bf16", False, None, True),
    ("encoder_bf16_overflow_chunk", (128, 6, 20, 20, 64), "bf16", False, None, True),
    ("encoder_fp32", (256, 6, 20, 20, 64), "fp32", False, None, False),
    ("causal_kvlen_fp32", (8, 4, 37, 53, 128), "fp32", True, 1, False),
    ("causal_kvlen_bf16", (8, 4, 37, 53, 128), "bf16", True, 1, False),
    # the LayoutLM heads (float32, kv_len = the pages' valid tokens)
    ("chain_heads_fp32", (16, 4, 192, 192, 64), "fp32", False, 1, True),
    # base classifier: 512 text tokens + 196 patches, the patches always valid
    ("layoutlm_base_cls_fp32", (16, 12, 708, 708, 64), "fp32", False, 197, True),
    ("layoutlm_base_ner_fp32", (7, 12, 512, 512, 64), "fp32", False, INDEXER, True),
]

INDEXER_WORDS = 1200  # the long page of phase_layoutlm_base


def _indexer_kv_len(b: int, window: int):
    """kv_len of the windows ``LayoutDocumentIndexer.logits`` builds for a
    page of INDEXER_WORDS words (window 512, stride 128: the last window
    ends at the page's end, so every window is full)."""
    import torch

    from marie_tpu_torch.models.layoutlm import sliding_windows

    tokens = torch.zeros(INDEXER_WORDS, dtype=torch.int32)
    _, _, _, valid = sliding_windows(tokens, torch.zeros(INDEXER_WORDS, 4), window=window,
                                     stride=128)
    if valid.shape[0] != b:
        raise AssertionError(f"{valid.shape[0]} indexer windows, not {b}")
    return valid.sum(dim=1).to(torch.int32).cuda()


def _attn_bound_bytes(mask, h, sq, d, esz):
    """Bytes K2's function must move: Q read and O written in full; of K,
    the keys some row of the batch row sees (a prefix: kv_len, or the
    causal limit of the last row); of V the same, or all of Skv where a
    query row sees no key (it averages V over Skv; K plays no part).
    ``mask`` is ``_sdpa_mask``'s [B, 1, Sq, Skv]."""
    b, _, _, skv = mask.shape
    seen = mask[:, 0].any(dim=1)                      # [B, Skv]
    k_rows = seen.sum(dim=1)
    blind = ~mask[:, 0].any(dim=2).all(dim=1)         # a row that sees no key
    v_rows = k_rows.masked_fill(blind, skv)
    return (2 * b * h * sq * d + h * d * int(k_rows.sum() + v_rows.sum())) * esz


def phase_k2():
    """K2 at the encoder's shape (B=256 crops, 6 heads, 20 tokens, D=64)
    in bf16 (the serving dtype) on contiguous [B,H,S,D] inputs and on the
    transposed [B,S,H,D] projections the encoder passes (the main path's
    layout), at the serving slice's fused batch of B=2,560 on the
    projections (the kernels line's row) and its overflow chunk of 128,
    in fp32 (TF32 off), a causal + kv_len case at D=128 with Sq != Skv,
    and the LayoutLM heads' float32 shapes with kv_len: the chain heads
    (B=16 pages, 4 heads, 192 tokens) and the base-width classifier (708
    tokens with the image patches) and indexer (the 7 full windows of 512
    of ``phase_layoutlm_base``'s 1,200-word page).  Times
    are cold (see cold_device_ms) and warm; SDPA is timed on the same
    inputs, with the equivalent boolean ``attn_mask`` where K2 masks."""
    import torch
    import torch.nn.functional as F

    from marie_tpu_torch.ops.kernels.flash_attention import attention_reference, flash_attention

    row = None
    dtypes = {"bf16": torch.bfloat16, "fp32": torch.float32}
    for i, (name, (b, h, sq, skv, d), tag, causal, kv_min, proj) in enumerate(K2_CASES):
        dtype = dtypes[tag]
        ragged = kv_min is not None
        if kv_min == INDEXER:
            kv_len = _indexer_kv_len(b, skv)
        elif ragged:
            kv_len = torch.randint(kv_min, skv + 1, (b,), device="cuda",
                                   generator=torch.Generator(device="cuda").manual_seed(
                                       SEED + 20 + i)).to(torch.int32)
        else:
            kv_len = None
        esz = torch.finfo(dtype).bits // 8
        kv_bytes = b * 4 if ragged else 0
        copies = n_copies((2 * b * h * sq * d + 2 * b * h * skv * d) * esz + kv_bytes)
        ins = [_attn_inputs(b, h, sq, skv, d, dtype, SEED + 10 + i + 100 * c, proj)
               for c in range(copies)]
        q, k, v = ins[0]
        scale = 1.0 / d ** 0.5
        got = flash_attention(q, k, v, kv_len=kv_len, causal=causal)
        want = attention_reference(q, k, v, causal=causal, kv_len=kv_len, sm_scale=scale)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        if not err <= K2_LIMITS[tag]:
            raise AssertionError(f"K2 {name} disagrees with its plain version: "
                                 f"max abs err {err} > {K2_LIMITS[tag]}")
        t_kernel = timed(lambda c: flash_attention(*ins[c], kv_len=kv_len, causal=causal),
                         copies)
        t_plain = timed(lambda c: attention_reference(
            *ins[c], causal=causal, kv_len=kv_len, sm_scale=scale), copies)
        mask = _sdpa_mask(b, sq, skv, kv_len, causal)
        # where the masks leave every pair, SDPA computes the function unmasked
        lib_mask = None if bool(mask.all()) else mask
        t_lib = timed(lambda c: F.scaled_dot_product_attention(*ins[c], attn_mask=lib_mask),
                      copies)
        del ins
        # score and PV flops of the (query, key) pairs the masks leave, at
        # the rate of the units the kernel runs them on (float32: 3xTF32)
        flops = 4 * h * d * int(mask.sum())
        nbytes = _attn_bound_bytes(mask, h, sq, d, esz) + kv_bytes
        bound_bytes = nbytes / H100_BYTES_PER_S * 1e3
        bound_ops = flops / H100_FLOPS["bf16" if tag == "bf16" else "3xtf32"] * 1e3
        simt = ({"bound_simt_ms": max(bound_bytes, flops / H100_FLOPS["fp32"] * 1e3)}
                if tag == "fp32" else {})
        entry = {"name": "flash_attention", "route": "cuda",
                 "source": "marie_tpu_torch/csrc/flash_attention.cu",
                 "replaces": "marie_tpu/ops/pallas/flash_attention.py:112",
                 "max_abs_err": err, "ms": t_kernel["cold"], "plain_ms": t_plain["cold"],
                 "bound_ms": max(bound_bytes, bound_ops),
                 "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
                 "library_ms": t_lib["cold"]}
        emit({"phase": "k2", "case": name, "shape": [b, h, sq, skv, d],
              "dtype": tag, "causal": causal, "kv_len": ragged,
              "kv_len_min": kv_min, "kv_len_mean": (float(kv_len.float().mean())
                                                     if ragged else None),
              "projections": proj, "bound_bytes": nbytes,
              "library": "SDPA" + (" with attn_mask" if lib_mask is not None else ""),
              "limit": K2_LIMITS[tag], "copies": copies, "warm_ms": t_kernel["warm"],
              "plain_warm_ms": t_plain["warm"], "library_warm_ms": t_lib["warm"],
              **entry, **simt})
        if name == "encoder_bf16_serving":
            row = entry
    return row


def _reset_counts():
    from marie_tpu_torch.ops.kernels import _build
    from marie_tpu_torch.ops.kernels.crop_resize import crop_resize
    from marie_tpu_torch.ops.kernels.flash_attention import flash_attention

    _build.reset_counts(crop_resize, flash_attention)


def _read_counts():
    """{kernel: {"all": n, path: n, ...}}: launches in all and by the
    engine path that made them ("fused" program, "overflow" rows)."""
    from marie_tpu_torch.ops.kernels.crop_resize import crop_resize
    from marie_tpu_torch.ops.kernels.flash_attention import flash_attention

    return {fn.__name__: {"all": fn.launches, **fn.launches_by_path}
            for fn in (crop_resize, flash_attention)}


def _check_results(results, n_pages, h, w):
    """The engine's result dicts: one per page, in page order, every word
    box inside the page, confidences in [0, 1], every word on one line."""
    import math

    if len(results) != n_pages:
        raise AssertionError(f"{len(results)} page results for {n_pages} pages")
    for i, page in enumerate(results):
        if page["meta"]["page"] != i or page["meta"]["imageSize"] != {"width": w, "height": h}:
            raise AssertionError(f"page {i}: meta {page['meta']}")
        for wd in page["words"]:
            x, y, bw, bh = wd["box"]
            if not (0 <= x and 0 <= y and bw > 0 and bh > 0
                    and x + bw <= w + 1 and y + bh <= h + 1):
                raise AssertionError(f"box out of the page: {wd['box']}")
            if not (math.isfinite(wd["confidence"]) and 0.0 <= wd["confidence"] <= 1.0):
                raise AssertionError(f"confidence not in [0, 1]: {wd['confidence']}")
            if not isinstance(wd["text"], str):
                raise AssertionError("text is not a string")
        if sorted(i for ln in page["lines"] for i in ln["wordids"]) != list(
                range(len(page["words"]))):
            raise AssertionError(f"page {i}: lines do not partition the words")


def serving_detector(source: str, pages, craft_tree):
    """The JAX serving configuration's detector (``bench.py``) at full
    width: CRAFT fast_s2d2 in bf16 with text_threshold 0.6, low_text 0.4,
    256 components and a CC run budget of 32.  For ``source="heatmap"``
    the thresholds are the 0.6 and 0.8 quantiles of the random-weight
    heatmap of ``pages`` instead: with random weights the served
    thresholds keep no component."""
    import numpy as np

    from marie_tpu_torch.boxes.craft_box_processor import BoxProcessorCraft
    from marie_tpu_torch.models.configs import CraftConfig
    from marie_tpu_torch.preprocess.buckets import BucketSpec

    bp = BoxProcessorCraft(
        CraftConfig.fast_s2d2(), craft_tree, text_threshold=0.6, low_text=0.4,
        max_components=256, bucket_spec=BucketSpec(shapes=(pages.shape[1:],)),
        box_source=source, param_dtype="bfloat16", device="cuda", cc_runs=32)
    if source == "heatmap":
        region = np.concatenate([bp.heatmap(pages[k:k + 8])[..., 0].cpu().numpy()
                                 for k in range(0, len(pages), 8)])
        bp.low_text = float(np.quantile(region, 0.6))
        bp.text_threshold = float(np.quantile(region, 0.8))
    return bp


def serving_recognizer():
    """The JAX serving configuration's recogniser at full width: TrOCR
    fast_v3_g2_d6 in bf16 with recognition chunks of 32, 128 and 256.
    It counts the rows its dispatch takes (``rows``): in the fused engine
    only the overflow rows go through it."""
    from marie_tpu_torch.document.trocr_ocr_processor import TrOcrProcessor
    from marie_tpu_torch.models.configs import TrOCRConfig
    from marie_tpu_torch.registry.convert import init_flax_layout

    class OverflowCountingTrOcr(TrOcrProcessor):
        rows = 0

        def recognize_dispatch(self, page_dev, boxes_xywh, scale=1.0):
            self.rows += len(boxes_xywh)
            return super().recognize_dispatch(page_dev, boxes_xywh, scale)

    cfg = TrOCRConfig.fast_v3_g2_d6()
    return OverflowCountingTrOcr(cfg, init_flax_layout(cfg, SEED + 1),
                                 param_dtype="bfloat16", batch_sizes=(32, 128, 256),
                                 device="cuda")


def serving_engine(bp, op):
    """``bench.py``'s engine settings: u2 uploads, 160 recognition rows a
    page, 16-page groups."""
    from marie_tpu_torch.ocr.ocr_engine import PipelineOcrEngine

    return PipelineOcrEngine(bp, op, upload_format="u2", compact_slots=160,
                             page_fuse_batch=16)


def phase_slice():
    """The main path in the JAX serving configuration at full width
    (``serving_detector``, ``serving_recognizer``, ``serving_engine``) on
    16 pages of 1024x768,
    box_source "ink" and then "heatmap".  Both runs must keep boxes; the
    ink run must send rows through the overflow path, and each kernel
    must launch on the fused path of both runs and on the overflow path
    of the ink run."""
    import torch

    from marie_tpu_torch.models.configs import CraftConfig
    from marie_tpu_torch.registry.convert import init_flax_layout

    n, h, w = SLICE_PAGES, 1024, 768
    pages = draw_pages(n, h, w, SEED + 3)
    craft_tree = init_flax_layout(CraftConfig.fast_s2d2(), SEED)
    op = serving_recognizer()
    counts, setups = {}, {}
    for source in ("ink", "heatmap"):
        bp = serving_detector(source, pages, craft_tree)
        engine = serving_engine(bp, op)
        engine.extract(pages)  # warm-up (kernel builds, cuDNN plans)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        op.rows = 0
        _reset_counts()
        t0 = time.perf_counter()
        results = engine.extract(pages)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts[source] = _read_counts()
        _check_results(results, n, h, w)
        kept = sum(len(r["words"]) for r in results)
        read = sum(1 for r in results for wd in r["words"] if wd["text"])
        emit({"phase": "slice", "box_source": source, "pages": n, "page_hw": [h, w],
              "craft": "fast_s2d2 bf16", "trocr": "fast_v3_g2_d6 bf16",
              "upload_format": engine.upload_format, "compact_slots": engine.compact_slots,
              "page_fuse_batch": engine.page_fuse_batch, "batch_sizes": op.batch_sizes,
              "cc_runs": bp.cc_runs, "max_components": bp.max_components,
              "low_text": bp.low_text, "text_threshold": bp.text_threshold,
              "thresholds": ("0.6/0.8 quantiles of the random-weight heatmap"
                             if source == "heatmap" else "served (unused by ink masks)"),
              "kept_boxes": kept, "overflow_rows": op.rows, "words_with_text": read,
              "lines": sum(len(r["lines"]) for r in results),
              "wall_ms_per_page": wall / n * 1e3, "launches": counts[source],
              "max_allocated_mb": torch.cuda.max_memory_allocated() / 2**20})
        if kept <= 0:
            raise AssertionError(f"{source} run kept no boxes")
        paths = ("fused", "overflow") if source == "ink" else ("fused",)
        for kernel, by_path in counts[source].items():
            for path in paths:
                if by_path.get(path, 0) <= 0:
                    raise AssertionError(f"{source}: {kernel} never launched on the "
                                         f"{path} path: {by_path}")
        if source == "ink" and op.rows <= 0:
            raise AssertionError("the ink run sent no rows through the overflow path")
        setups[source] = engine
    launches = {k: v["all"] for k, v in counts["heatmap"].items()}
    return launches, setups, pages


def phase_stream(engine, pages16):
    """48 pages (3 groups of 16) through ``extract`` with
    ``on_result_group``: pages/s, each group's arrival on the host, and
    whether group i's collect began before group i+1's device work ended
    (the group's event on the card, against the host clock aligned to the
    card by an event recorded at the start)."""
    import numpy as np
    import torch

    import marie_tpu_torch.ocr.ocr_engine as ocr_engine

    pages = np.concatenate([pages16, draw_pages(32, *pages16.shape[1:], SEED + 6)])
    collects = []  # (host ms at collect begin, the group's ready event)
    inner = ocr_engine.fused_collect_many

    def timed_collect(bp, op, handles, pms_modes):
        collects.append(((time.perf_counter() - t0) * 1e3, handles[0].ready))
        return inner(bp, op, handles, pms_modes)

    arrivals = []
    ocr_engine.fused_collect_many = timed_collect
    try:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        results = engine.extract(pages, on_result_group=lambda rs, s: arrivals.append(
            (s, len(rs), (time.perf_counter() - t0) * 1e3)))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        ocr_engine.fused_collect_many = inner
    _check_results(results, len(pages), *pages.shape[1:])
    device_end = [start.elapsed_time(ev) for _, ev in collects]
    overlap = [collects[i][0] < device_end[i + 1] for i in range(len(collects) - 1)]
    emit({"phase": "stream", "pages": len(pages), "groups": [[s, n] for s, n, _ in arrivals],
          "pages_per_s": len(pages) / wall, "wall_ms": wall * 1e3,
          "arrival_ms": [t for _, _, t in arrivals],
          "collect_begin_ms": [t for t, _ in collects],
          "device_end_ms": device_end,
          "collect_began_before_next_group_ended": overlap})
    if [s for s, _, _ in arrivals] != [0, 16, 32] or [n for _, n, _ in arrivals] != [16] * 3:
        raise AssertionError(f"groups arrived as {arrivals}")


def phase_precision():
    """A default BoxProcessorCraft (float32, allow_tf32=False) on the
    card: its heatmap with torch's global TF32 switches on equals the one
    with them off (limit 0: both forwards run in full float32, so cuDNN
    picks the same algorithms), and the switches read as set afterwards.
    A processor with allow_tf32=True shows what TF32 would change."""
    import torch

    from marie_tpu_torch.boxes.craft_box_processor import BoxProcessorCraft
    from marie_tpu_torch.utils.device import _precision_flags

    read, write, n = _precision_flags()
    start = read()
    pages = draw_pages(4, 1024, 768, SEED + 7)
    bp = BoxProcessorCraft(device="cuda")
    bp_tf32 = BoxProcessorCraft(device="cuda", allow_tf32=True)
    try:
        write(("ieee",) * n)
        off = bp.heatmap(pages)
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        flags_on = read()
        on = bp.heatmap(pages)
        tf32 = bp_tf32.heatmap(pages)
        torch.cuda.synchronize()
        after = read()
        legacy = [torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32]
    finally:
        write(start)
    err = float((on - off).abs().max())
    emit({"phase": "precision", "pages": len(pages), "flags_set": flags_on,
          "flags_after": after, "legacy_after": legacy, "max_abs_err": err, "limit": 0.0,
          "tf32_max_abs_diff": float((tf32 - off).abs().max())})
    if after != flags_on or legacy != [True, True]:
        raise AssertionError(f"the engine left the flags changed: {flags_on} -> {after}")
    if err > 0.0:
        raise AssertionError(f"the default CRAFT depends on the global TF32 flags: {err}")


def phase_profile(setups):
    """Where the serving slice's time goes: torch.profiler over one more
    extract per engine on its pages (``setups``: {name: (engine, pages)};
    ``slice``'s two box sources, ``chain``'s heatmap engine, the
    ``trained`` engine and the ``best`` engine on two pages), on every
    thread; wall time, device busy time, the
    ``marie.*`` stage ranges (counts and times summed over threads;
    ``marie.heads`` for the chained heads) and the kernels with the most
    device time."""
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for source, (engine, pages) in setups.items():
        torch.cuda.synchronize()
        # all threads: the page program runs on the engine's upload worker
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
            t0 = time.perf_counter()
            engine.extract(pages)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = prof.key_averages()
        # marie.* ranges come back twice: the host range (CPU) and its span
        # on the device timeline (CUDA, first to last kernel, gaps included)
        ranges = {}
        for e in events:
            if e.key.startswith("marie."):
                r = ranges.setdefault(e.key, {"count": e.count})
                if e.device_type == DeviceType.CPU:
                    r["host_ms"] = e.cpu_time_total / 1e3
                else:
                    r["device_span_ms"] = e.device_time_total / 1e3
        kernels = [e for e in events if e.device_type == DeviceType.CUDA
                   and not e.key.startswith("marie.")]
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
        emit({"phase": "profile", "box_source": source, "pages": len(pages),
              "wall_ms": wall_ms, "device_busy_ms": busy_ms,
              "busy_share": busy_ms / wall_ms, "kernel_launches": sum(e.count for e in kernels),
              "ranges": ranges,
              "top_kernels": [[e.key[:90], e.self_device_time_total / 1e3, e.count]
                              for e in top]})


def _score_errors(got, want):
    """Max abs difference of each kind of float score: word and line
    ``confidence``, the chained heads' per-word ``ner_score`` and the
    page's ``classification`` score (-1 where one side lacks it)."""
    def scores(results, kind):
        if kind == "classification":
            return [r["classification"]["score"] for r in results if "classification" in r]
        return [x.get(kind, -1.0) for r in results for x in r["words"] + r["lines"]]

    out = {}
    for kind in ("confidence", "ner_score", "classification"):
        a, b = scores(got, kind), scores(want, kind)
        out[kind] = (max((abs(x - y) for x, y in zip(a, b)), default=0.0)
                     if len(a) == len(b) else float("inf"))
    return out


def _results_equal(got, want):
    """(equal apart from float scores, max score difference; see
    ``_score_errors``)."""
    def strip(results):
        out = []
        for r in results:
            r = dict(r, words=[dict(w, confidence=None, ner_score=None) for w in r["words"]],
                     lines=[dict(ln, confidence=None) for ln in r["lines"]])
            if "classification" in r:
                r["classification"] = dict(r["classification"], score=None)
            out.append(r)
        return out

    return strip(got) == strip(want), max(_score_errors(got, want).values())


def phase_small_reference():
    """The engine on a small input on the card against the plain CPU path
    (tiny configs, float32; the processors hold full float32 themselves):
    equal result dicts (words, boxes, lines, line boxes, texts;
    confidences within 1e-3), with a row budget that the pages overflow."""
    import torch

    from marie_tpu_torch.boxes.craft_box_processor import BoxProcessorCraft
    from marie_tpu_torch.document.trocr_ocr_processor import TrOcrProcessor
    from marie_tpu_torch.models.configs import CraftConfig, TrOCRConfig
    from marie_tpu_torch.ocr.ocr_engine import PipelineOcrEngine
    from marie_tpu_torch.preprocess.buckets import BucketSpec
    from marie_tpu_torch.registry.convert import init_flax_layout

    pages = draw_pages(2, 256, 384, SEED + 4)
    craft = init_flax_layout(CraftConfig.tiny(), SEED + 5)
    trocr = init_flax_layout(TrOCRConfig.tiny(), SEED + 6)
    out = {}
    for dev in ("cpu", "cuda"):
        bp = BoxProcessorCraft(CraftConfig.tiny(), craft, box_source="ink", min_area=4,
                               max_components=64, bucket_spec=BucketSpec(shapes=((256, 384),)),
                               device=dev)
        op = TrOcrProcessor(TrOCRConfig.tiny(), trocr, batch_sizes=(8, 32), device=dev)
        _reset_counts()
        out[dev] = PipelineOcrEngine(bp, op, page_fuse_batch=2, compact_slots=8).extract(pages)
        torch.cuda.synchronize()
        launches = _read_counts()
    equal, conf_err = _results_equal(out["cuda"], out["cpu"])
    words = sum(len(r["words"]) for r in out["cpu"])
    emit({"phase": "small_reference", "words": words, "row_budget": 16,
          "lines": sum(len(r["lines"]) for r in out["cpu"]),
          "results_equal": equal, "max_conf_err": conf_err, "launches": launches})
    if not (equal and words > 16 and conf_err <= 1e-3):
        raise AssertionError(f"card and CPU disagree on the small slice: equal {equal}, "
                             f"{words} words, max confidence error {conf_err}")
    if launches["crop_resize"].get("overflow", 0) <= 0:
        raise AssertionError(f"no overflow rows on the card: {launches}")


def chain_heads(device, num_layers=None, seq_cap=192, vocab=8192, width=None, seed=SEED + 8):
    """bench.py's chain heads (``from_zoo_chain``: LayoutLMConfig.synth,
    sequence cap 192, RollingWordTokenizer ids; 3 classes and the 5
    SYNTH_NER_LABELS) with weights drawn from ``seed``; the keywords cut
    them to a small size."""
    import dataclasses

    from marie_tpu_torch.components.document_classifier import LayoutDocumentClassifier
    from marie_tpu_torch.components.document_classifier.layoutlm_classifier import (
        SYNTH_CLASS_LABELS,
    )
    from marie_tpu_torch.components.document_indexer import LayoutDocumentIndexer
    from marie_tpu_torch.components.document_indexer.layoutlm_indexer import SYNTH_NER_LABELS
    from marie_tpu_torch.components.word_tokenizer import RollingWordTokenizer
    from marie_tpu_torch.models.configs import LayoutLMConfig
    from marie_tpu_torch.registry.convert import init_flax_layout

    heads = []
    for k, (cls, labels, head) in enumerate((
            (LayoutDocumentClassifier, SYNTH_CLASS_LABELS, "sequence"),
            (LayoutDocumentIndexer, SYNTH_NER_LABELS, "token"))):
        cfg = dataclasses.replace(LayoutLMConfig.synth(len(labels)), max_seq_len=seq_cap,
                                  vocab_size=vocab)
        if width is not None:
            cfg = dataclasses.replace(cfg, hidden_dim=width, num_heads=width // 32,
                                      mlp_dim=2 * width, num_layers=num_layers)
        heads.append(cls(labels=labels, config=cfg, params=init_flax_layout(cfg, seed + k, head),
                         tokenizer=RollingWordTokenizer(vocab), device=device))
    return heads


def phase_chain_reference():
    """The chained engine on a small input on the card against the plain
    CPU path (tiny CRAFT and TrOCR as in ``small_reference``, two-layer
    heads of width 64 with a sequence cap of 8, below the pages' word
    counts): equal result dicts (words, lines, classification label ids,
    every word's NER label id; scores within 1e-3), with rows past the
    budget and words past the cap."""
    import torch

    from marie_tpu_torch.boxes.craft_box_processor import BoxProcessorCraft
    from marie_tpu_torch.document.trocr_ocr_processor import TrOcrProcessor
    from marie_tpu_torch.models.configs import CraftConfig, TrOCRConfig
    from marie_tpu_torch.ocr.ocr_engine import PipelineOcrEngine
    from marie_tpu_torch.preprocess.buckets import BucketSpec
    from marie_tpu_torch.registry.convert import init_flax_layout

    pages = draw_pages(2, 256, 384, SEED + 4)
    craft = init_flax_layout(CraftConfig.tiny(), SEED + 5)
    trocr = init_flax_layout(TrOCRConfig.tiny(), SEED + 6)
    out = {}
    for dev in ("cpu", "cuda"):
        bp = BoxProcessorCraft(CraftConfig.tiny(), craft, box_source="ink", min_area=4,
                               max_components=64, bucket_spec=BucketSpec(shapes=((256, 384),)),
                               device=dev)
        op = TrOcrProcessor(TrOCRConfig.tiny(), trocr, batch_sizes=(8, 32), device=dev)
        cls, ner = chain_heads(dev, num_layers=2, seq_cap=8, vocab=512, width=64)
        _reset_counts()
        out[dev] = PipelineOcrEngine(bp, op, page_fuse_batch=2, compact_slots=8,
                                     classifier=cls, indexer=ner).extract(pages)
        torch.cuda.synchronize()
        launches = _read_counts()
    equal, err = _results_equal(out["cuda"], out["cpu"])
    words = sum(len(r["words"]) for r in out["cpu"])
    labelled = sum(1 for r in out["cpu"] for w in r["words"] if "ner_label" in w)
    emit({"phase": "chain_reference", "words": words, "row_budget": 16, "seq_cap": 8,
          "ner_labelled_words": labelled, "results_equal": equal, "max_score_err": err,
          "limit": 1e-3, "launches": launches})
    if not (equal and words > 16 and err <= 1e-3):
        raise AssertionError(f"card and CPU disagree on the small chain: equal {equal}, "
                             f"{words} words, max score error {err}")
    if not 0 < labelled < words or launches["flash_attention"].get("heads", 0) != 2 * 2:
        raise AssertionError(f"no words past the cap or no heads on the card: {labelled} "
                             f"of {words} labelled, launches {launches}")


def phase_chain(setups, pages):
    """The chained engine (the processors and settings of ``slice``'s
    engines plus the seeded chain heads of ``chain_heads``: classify + NER
    in each group's program) on the slice's 16 pages, box_source "ink"
    then "heatmap":
    ms/page, classified pages, NER-labelled words, K1/K2 launches by
    path.  Every page must be classified and K2 must launch 8 times (4
    layers x 2 heads) on the "heads" path of the one 16-page group.
    Returns (the heatmap run's launches, the engines, the heatmap run's
    results)."""
    import torch

    from marie_tpu_torch.ocr.ocr_engine import PipelineOcrEngine

    n, h, w = pages.shape
    cls, ner = chain_heads("cuda")
    engines, launches, results = {}, None, None
    for source in ("ink", "heatmap"):
        base = setups[source]
        engine = PipelineOcrEngine(base.box_processor, base.ocr_processor,
                                   upload_format=base.upload_format,
                                   compact_slots=base.compact_slots,
                                   page_fuse_batch=base.page_fuse_batch,
                                   classifier=cls, indexer=ner)
        engine.extract(pages)  # warm-up
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        results = engine.extract(pages)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_counts()
        _check_results(results, n, h, w)
        words = sum(len(r["words"]) for r in results)
        classified = sum(1 for r in results if "classification" in r)
        labelled = sum(1 for r in results for wd in r["words"] if "ner_label" in wd)
        emit({"phase": "chain", "box_source": source, "pages": n,
              "heads": "LayoutLMConfig.synth(3|5), max_seq_len 192, seeded",
              "wall_ms_per_page": wall / n * 1e3, "classified_pages": classified,
              "ner_labelled_words": labelled, "words": words,
              "labels": sorted({r["classification"]["label"] for r in results}),
              "launches": launches})
        if classified != n:
            raise AssertionError(f"{source}: {classified} of {n} pages classified")
        if launches["flash_attention"].get("heads", 0) != 8:
            raise AssertionError(f"{source}: K2 launched {launches['flash_attention']} "
                                 "times, not 8 on the heads path of one group")
        if labelled <= 0:
            raise AssertionError(f"{source}: no word got an NER label")
        engines[source] = engine
    return launches, engines, results


def _seeded_page(n_words: int, seed: int):
    """A PageInput of ``n_words`` words drawn from a small vocabulary, in
    rows of 30 on a 768x1024 page."""
    import numpy as np

    from marie_tpu_torch.components.base import PageInput

    vocab = ["invoice", "total", "due", "date", "amount", "claim", "no.", "paid", "member",
             "12/01/2023", "$45.00", "555-123-4567", "Main", "St", "Springfield", "IL"]
    rng = np.random.default_rng(seed)
    words = [vocab[int(i)] for i in rng.integers(0, len(vocab), n_words)]
    boxes = [[float(20 + 24 * (i % 30)), float(10 + 25 * (i // 30)), 22.0, 16.0]
             for i in range(n_words)]
    return PageInput(words, boxes, page_size=(768, 1024))


def _ms_per_call(fn, reps: int = 3):
    """(median host ms of ``fn()`` to a synchronised card, its last result)."""
    import torch

    fn()
    times, out = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


LAYOUT_LIMIT = 1e-3  # card vs CPU logits, float32 through 12 layers at width 768


def phase_layoutlm_base(pages, chain_results):
    """The document components at LayoutLMv3-base width (768 wide, 12
    layers of 12 heads, 512 tokens, seeded weights): the classifier
    (``base(3)``, with the 224x224 image branch: 708 tokens) on the 16
    pages' OCR words, boxes and images from ``chain``, the indexer
    (``base(5)``) on one page of 1,200 seeded words (7 windows of 512 at
    stride 128), and the splitter over the classifier's weights and
    labels.  ms per call; K2 launches 12 times per forward; the card's
    logits against the CPU's on 2 pages each (limit LAYOUT_LIMIT)."""
    import torch

    from marie_tpu_torch.components.base import PageInput
    from marie_tpu_torch.components.document_classifier import LayoutDocumentClassifier
    from marie_tpu_torch.components.document_indexer import LayoutDocumentIndexer
    from marie_tpu_torch.components.document_splitter import LayoutDocumentSplitter
    from marie_tpu_torch.models.configs import LayoutLMConfig
    from marie_tpu_torch.ops.kernels.flash_attention import flash_attention
    from marie_tpu_torch.registry.convert import init_flax_layout

    labels, ner_labels = ("invoice", "correspondence", "claim"), ("O", "B-KEY", "I-KEY",
                                                                  "B-VALUE", "I-VALUE")
    cls_cfg, ner_cfg = LayoutLMConfig.base(3), LayoutLMConfig.base(5)
    t0 = time.perf_counter()
    cls_tree = init_flax_layout(cls_cfg, SEED + 10, "sequence")
    ner_tree = init_flax_layout(ner_cfg, SEED + 11, "token")
    docs = [PageInput.from_ocr_result(r, image=p) for r, p in zip(chain_results, pages)]
    long_page = _seeded_page(INDEXER_WORDS, SEED + 12)
    # batches of 2 (the CPU check) and 16 (the pages)
    cls = LayoutDocumentClassifier(labels, cls_cfg, cls_tree, batch_sizes=(2, 16),
                                   device="cuda")
    ner = LayoutDocumentIndexer(ner_labels, ner_cfg, ner_tree, device="cuda")
    splitter = LayoutDocumentSplitter(labels, labels[0], cls_cfg, cls_tree, device="cuda")

    row = {"phase": "layoutlm_base", "width": [768, 12, 12, 3072], "pages": len(docs),
           "long_page_words": INDEXER_WORDS, "limit": LAYOUT_LIMIT,
           "setup_s": time.perf_counter() - t0}
    for name, fn in (("predict", lambda: cls.predict(docs)),
                     ("index", lambda: ner.index([long_page])),
                     ("split", lambda: splitter.split(docs))):
        row[f"{name}_ms"], out = _ms_per_call(fn)
        _reset_counts()
        fn()
        torch.cuda.synchronize()
        k2 = flash_attention.launches_by_path.get("heads", 0)
        row[f"{name}_k2_launches"] = k2
        if k2 != 12:
            raise AssertionError(f"{name}: K2 launched {k2} times on the heads path, not 12")
        row[f"{name}_out"] = (len(out[0]["entities"]) if name == "index"
                              else [p["label"] for p in out])
    if row["split_out"] != row["predict_out"]:
        raise AssertionError("the splitter and the classifier disagree on the same weights")
    row["documents"] = len(LayoutDocumentSplitter.to_documents(splitter.split(docs)))

    # card against CPU: classifier on 2 pages, indexer on a chain page and
    # a 600-word page (2 windows)
    t0 = time.perf_counter()
    cls_cpu = LayoutDocumentClassifier(labels, cls_cfg, cls_tree, batch_sizes=(2, 16),
                                       device="cpu")
    ner_cpu = LayoutDocumentIndexer(ner_labels, ner_cfg, ner_tree, device="cpu")
    errs = [float((cls.logits(docs[:2]).cpu() - cls_cpu.logits(docs[:2])).abs().max())]
    for page in (docs[0], _seeded_page(600, SEED + 13)):
        errs.append(float((ner.logits(page).cpu() - ner_cpu.logits(page)).abs().max()))
    row.update(max_abs_err_cls=errs[0], max_abs_err_ner=errs[1:],
               cpu_check_s=time.perf_counter() - t0)
    emit(row)
    if not max(errs) <= LAYOUT_LIMIT:
        raise AssertionError(f"card and CPU logits differ by {errs} > {LAYOUT_LIMIT}")


#: card vs CPU scores of the bfloat16 serving engine: one bfloat16
#: rounding of the decoder's logits moves a word's confidence by up to
#: ~1e-2 (the float32 engines of small_reference and chain_reference keep
#: 1e-3, the 3-decimal rounding of confidences)
BF16_SCORE_LIMIT = 2e-2

#: agreement of a card run with the JAX engine's golden (``trained`` and
#: ``forms``): matched golden words (IoU >= 0.5) with equal text, recall
#: and CER against the truth (IoU >= 0.4, as bench.py) next to the golden's
TEXT_AGREEMENT = 0.99
RECALL_DELTA = 0.005
CER_DELTA = 0.005


def load_shipped():
    """The pages, truth and golden of ``torch_zoo/`` (made with the JAX
    package by ``scripts/export_torch_zoo.py``); missing files fail."""
    import numpy as np

    from marie_tpu_torch.registry.zoo import ZOO_DIR

    with np.load(os.path.join(ZOO_DIR, "pages.npz")) as data:
        shipped = {k: data[k] for k in data.files}
    for name in ("truth", "golden"):
        with open(os.path.join(ZOO_DIR, f"{name}.json")) as f:
            shipped[name] = json.load(f)
    return shipped


def zoo_engine(device: str):
    """``bench.py``'s serving engine over the zoo's trained trees, with the
    chained heads: the registry's loaders (``ocr/util.py``) with bench's
    settings (256 components, CC run budget 32, chunks of 32/128/256, u2,
    160 rows a page, 16-page groups).  Fails unless all four trees load."""
    from marie_tpu_torch.components.document_classifier import LayoutDocumentClassifier
    from marie_tpu_torch.components.document_indexer import LayoutDocumentIndexer
    from marie_tpu_torch.ocr.ocr_engine import PipelineOcrEngine
    from marie_tpu_torch.ocr.util import craft_box_processor, trocr_processor

    engine = PipelineOcrEngine(
        craft_box_processor(256, cc_runs=32, device=device),
        trocr_processor(device=device, batch_sizes=(32, 128, 256)),
        upload_format="u2", compact_slots=160, page_fuse_batch=16,
        classifier=LayoutDocumentClassifier.from_zoo_chain(device=device),
        indexer=LayoutDocumentIndexer.from_zoo_chain(device=device))
    if len(engine.trained) != 4 or not all(engine.trained.values()):
        raise AssertionError(f"the engine is not trained: {engine.trained}")
    return engine


def _quality(results, truth, hw):
    """Detection and recognition against the truth (bench.py's IoU 0.4)."""
    from marie_tpu_torch.check import compare_results, truth_pages

    report = compare_results(truth_pages(truth, [hw] * len(truth)), results,
                             iou_threshold=0.4)
    return {**report["detection"], "cer": report["recognition"]["cer"]}


def _against_golden(results, golden, truth=None, hw=None):
    """The card's agreement with the golden, its quality and the golden's
    against the truth (when given), and the limits they met."""
    from marie_tpu_torch.check import agreement

    row = {"agreement": agreement(golden, results)}
    ok = row["agreement"]["words"] >= TEXT_AGREEMENT and not row["agreement"]["label_pages"]
    if truth is not None:
        row["quality"] = _quality(results, truth, hw)
        row["golden_quality"] = _quality(golden, truth, hw)
        ok = ok and (abs(row["quality"]["recall"] - row["golden_quality"]["recall"])
                     <= RECALL_DELTA)
        ok = ok and row["quality"]["cer"] <= row["golden_quality"]["cer"] + CER_DELTA
    row["within_limits"] = ok
    return row


def phase_trained(shipped):
    """The serving engine on the trained trees (``zoo_engine``) with the
    chained heads on the 16 shipped 1024x768 pages, twice: ms/page of the
    second call, kept boxes, recall, precision, mean IoU and CER against
    the truth, and agreement with the golden; fails outside the limits
    (text agreement >= 0.99, recall within 0.005 and CER at most 0.005
    over the golden's, equal page labels where every word agrees), or
    unless K1 and K2 launch on the fused path and K2 8 times on the heads
    path.  Returns (engine, launches of the second call)."""
    import torch

    engine = zoo_engine("cuda")
    pages = list(shipped["pages"])
    n, (h, w) = len(pages), pages[0].shape
    t0 = time.perf_counter()
    engine.extract(pages)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    _reset_counts()
    t0 = time.perf_counter()
    results = engine.extract(pages)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counts()
    _check_results(results, n, h, w)
    row = _against_golden(results, shipped["golden"]["pages"], shipped["truth"]["pages"],
                          (h, w))
    emit({"phase": "trained", "pages": n, "page_hw": [h, w], "trees": engine.trained,
          "first_call_s": first_s, "wall_ms_per_page": wall / n * 1e3,
          "kept_boxes": sum(len(r["words"]) for r in results),
          "golden_boxes": sum(len(r["words"]) for r in shipped["golden"]["pages"]),
          "labels": sorted({r["classification"]["label"] for r in results}),
          "launches": launches, **row})
    if not row["within_limits"]:
        raise AssertionError(f"the trained run is outside the golden's limits: {row}")
    if (launches["crop_resize"].get("fused", 0) <= 0
            or launches["flash_attention"].get("fused", 0) <= 0
            or launches["flash_attention"].get("heads", 0) != 8):
        raise AssertionError(f"trained run launches: {launches}")
    return engine, launches


def _region_pages(regions):
    """Region outputs as page-like dicts for the comparisons (a region's
    confidence is its words' mean)."""
    return [{"words": r["words"], "lines": [], "meta": {"id": r["id"], "text": r["text"]}}
            for r in regions]


def phase_forms(card_engine, shipped):
    """The page forms and modes on the card, each against the port's CPU
    path on the same trees (``zoo_engine("cpu")``: equal words, boxes,
    lines and labels, scores within ``BF16_SCORE_LIMIT``) and against
    the golden (the ``trained`` limits; recall and CER against the truth
    where the form has one): the RGB page, the oversize page (scaled by ~0.602 into the
    2048x1536 bucket), a region request on page 2 (RAW_LINE, WORD,
    MULTI_LINE and SPARSE regions) and RAW_LINE, WORD and MULTI_LINE
    requests on snippets of page 3.  K2 must launch on the fragments
    path.  Returns the launches of the card runs, summed by path."""
    import torch

    from marie_tpu_torch.enums import PSMode

    pages, golden, truth = shipped["pages"], shipped["golden"], shipped["truth"]
    cpu_engine = zoo_engine("cpu")

    def snippet(spec):
        x, y, w, h = spec["box"]
        return pages[spec["page"]][y:y + h, x:x + w]

    cases = [
        ("rgb", lambda e: e.extract([shipped["rgb"]]), [golden["forms"]["rgb"]],
         [truth["rgb"]], shipped["rgb"].shape[:2]),
        ("oversize", lambda e: e.extract([shipped["oversize"]]),
         [golden["forms"]["oversize"]], [truth["oversize"]], shipped["oversize"].shape),
        ("regions", lambda e: _region_pages(e.extract(
            list(pages), regions=golden["regions"]["request"])),
         _region_pages(golden["regions"]["result"]), None, None),
    ] + [
        (mode, lambda e, spec=spec, mode=mode: e.extract([snippet(spec)],
                                                          PSMode.from_value(mode)),
         [spec["result"]], None, None)
        for mode, spec in golden["modes"].items()
    ]
    totals, failed = {}, []
    for name, run, want, form_truth, hw in cases:
        _reset_counts()
        t0 = time.perf_counter()
        got = run(card_engine)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches = _read_counts()
        for kernel, by_path in launches.items():
            for path, count in by_path.items():
                totals.setdefault(kernel, {}).setdefault(path, 0)
                totals[kernel][path] += count
        cpu = run(cpu_engine)
        equal, score_err = _results_equal(got, cpu)
        row = _against_golden(got, want, form_truth, hw)
        emit({"phase": "forms", "case": name, "wall_ms": wall_ms,
              "words": sum(len(r["words"]) for r in got),
              "texts": [wd["text"] for r in got for wd in r["words"]][:12],
              "card_equals_cpu": equal, "score_errors": _score_errors(got, cpu),
              "score_limit": BF16_SCORE_LIMIT, "launches": launches, **row})
        if not (equal and score_err <= BF16_SCORE_LIMIT and row["within_limits"]):
            failed.append(name)
    emit({"phase": "forms", "case": "all", "launches": totals, "failed": failed})
    if failed:
        raise AssertionError(f"forms outside their limits: {failed}")
    if totals["flash_attention"].get("fragments", 0) <= 0:
        raise AssertionError(f"K2 never launched on the fragments path: {totals}")
    return totals


class _Candidates:
    """A recogniser that keeps what its last collect returned: the
    candidates of each word, per page, in detection order."""

    def __init__(self, proc):
        self.proc = proc
        self.out = []

    def __getattr__(self, name):
        return getattr(self.proc, name)

    def recognize_collect_many(self, futures_lists):
        self.out = self.proc.recognize_collect_many(futures_lists)
        return self.out


def best_engine(device: str):
    """The registry's ``best`` engine (CRAFT, TrOCR beam-5, CRNN from the
    zoo) with its recognisers wrapped in ``_Candidates``.  Fails unless
    every tree loads."""
    from marie_tpu_torch.ocr.util import get_known_ocr_engines

    engine = get_known_ocr_engines(device, "best")["best"]
    trained = engine.trained
    if not (trained["detector"] and all(trained["recognizers"])
            and len(trained["recognizers"]) == 2):
        raise AssertionError(f"the best engine is not trained: {trained}")
    engine.ocr_processors = [_Candidates(p) for p in engine.ocr_processors]
    return engine


def _vote_compare(card, cpu, card_cands, cpu_cands):
    """Card against CPU for the ``best`` engine: (equal apart from texts
    and scores, the flips, other text differences, the largest score
    difference of words with equal texts).  A flip is a word whose vote
    went another way on the two sides while both recognisers read the
    same texts on both, and their confidences lay at most
    BF16_SCORE_LIMIT apart: a 1-vs-1 vote decided by confidence."""
    from marie_tpu_torch.ocr.voting_ocr_engine import VotingOcrEngine

    def strip(results):
        return [dict(r, words=[dict(w, text=None, confidence=None) for w in r["words"]],
                     lines=[dict(ln, text=None, confidence=None) for ln in r["lines"]])
                for r in results]

    equal = strip(card) == strip(cpu)
    flips, other, score_err = 0, [], 0.0
    for page, (a, b) in enumerate(zip(card_cands, cpu_cands)):
        for j, (ca, cb) in enumerate(zip(zip(*a), zip(*b))):
            va = VotingOcrEngine._vote(list(ca))
            vb = VotingOcrEngine._vote(list(cb))
            if va["text"] == vb["text"]:
                score_err = max(score_err, abs(va["confidence"] - vb["confidence"]))
                continue
            same_reads = [x["text"] for x in ca] == [x["text"] for x in cb]
            gaps = [abs(c[0]["confidence"] - c[1]["confidence"]) for c in (ca, cb)]
            if same_reads and len(ca) == 2 and max(gaps) <= BF16_SCORE_LIMIT:
                flips += 1
            else:
                other.append({"page": page, "word": j, "card": list(ca), "cpu": list(cb)})
    return equal, flips, other, score_err


#: card vs CPU boxes of the bf16 detector (``best``): cuDNN's bf16
#: convolutions round unlike the CPU's (``scripts/probe_best.py`` shows
#: heatmaps up to 0.041 apart, which move one or two of ~140 boxes a page
#: by 2-3 px on an H100); a moved box keeps this IoU with its CPU twin
BOX_IOU_LIMIT = 0.9


def _detections_compare(card_pages, cpu_pages):
    """The detector, card against CPU (``_detect_pages`` of each side):
    (equal box counts and line numbers on every page, boxes moved, the
    least IoU of a moved box with its CPU twin)."""
    import numpy as np

    from marie_tpu_torch.utils.overlap import compute_iou

    same, moved, least_iou = True, 0, 1.0
    for (_, a), (_, b) in zip(card_pages, cpu_pages):
        boxes_a, boxes_b = np.asarray(a[0]), np.asarray(b[0])
        if boxes_a.shape != boxes_b.shape or not np.array_equal(a[2], b[2]):
            same = False
            continue
        for x, y in zip(boxes_a.tolist(), boxes_b.tolist()):
            if x != y:
                moved += 1
                least_iou = min(least_iou, compute_iou(
                    [x[0], x[1], x[0] + x[2], x[1] + x[3]],
                    [y[0], y[1], y[0] + y[2], y[1] + y[3]]))
    return same, moved, least_iou


def phase_best(shipped):
    """The ``best`` engine of the registry (CRAFT detection, a word-level
    vote of TrOCR beam-5 and the CRNN, on the zoo's trees) on the 16
    shipped pages, twice: ms/page of the second call; recall, precision,
    mean IoU and CER against the truth for the vote and for each
    recogniser alone; agreement with the JAX engine's golden
    (``golden_best.json``: text >= 0.99, recall within 0.005, CER at
    most 0.005 over the golden's); the 1-vs-1 votes decided by
    confidence; K1 and K2 launches on the ``"best"`` path (both > 0).
    Then the WORD request against its golden, and card against CPU on
    two pages: the detections (equal box counts and lines; boxes the
    bf16 detector moves are counted and keep IoU >= BOX_IOU_LIMIT), then
    both sides' recognisers and vote on the card's detections: equal
    result dicts apart from texts and scores, equal texts apart from
    counted flips (``_vote_compare``), scores within BF16_SCORE_LIMIT.
    Returns (engine, launches of the second call)."""
    import torch

    from marie_tpu_torch.enums import PSMode
    from marie_tpu_torch.ocr.voting_ocr_engine import VotingOcrEngine
    from marie_tpu_torch.registry.zoo import ZOO_DIR

    with open(os.path.join(ZOO_DIR, "golden_best.json")) as f:
        golden = json.load(f)
    engine = best_engine("cuda")
    pages = list(shipped["pages"])
    n, (h, w) = len(pages), pages[0].shape
    t0 = time.perf_counter()
    engine.extract(pages)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    _reset_counts()
    t0 = time.perf_counter()
    results = engine.extract(pages)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counts()
    _check_results(results, n, h, w)
    trocr, crnn = (p.out for p in engine.ocr_processors)
    by_confidence = sum(1 for a, b in zip(trocr, crnn) for x, y in zip(a, b)
                        if x["text"] != y["text"])
    words = sum(len(r["words"]) for r in results)
    row = _against_golden(results, golden["pages"], shipped["truth"]["pages"], (h, w))
    alone = {}
    for name, proc in (("trocr_beam5", engine.ocr_processors[0].proc),
                       ("crnn", engine.ocr_processors[1].proc)):
        alone[name] = _quality(VotingOcrEngine(engine.box_processor, [proc]).extract(pages),
                               shipped["truth"]["pages"], (h, w))
    spec = golden["word"]
    x, y, bw, bh = spec["box"]
    word = engine.extract([pages[spec["page"]][y:y + bh, x:x + bw]], PSMode.WORD)
    word_equal, word_err = _results_equal(word, [spec["result"]])

    t0 = time.perf_counter()
    cpu_engine = best_engine("cpu")
    two = pages[:2]
    card_pages = engine._detect_pages(two, PSMode.SPARSE)
    cpu_pages = cpu_engine._detect_pages(two, PSMode.SPARSE)
    same_lines, moved, least_iou = _detections_compare(card_pages, cpu_pages)
    # both sides recognise the card's detections (the CPU its own copy of
    # each page)
    engine._detect_pages = lambda frames, mode: card_pages
    cpu_engine._detect_pages = lambda frames, mode: [
        (handle, page) for (handle, _), (_, page) in zip(cpu_pages, card_pages)]
    try:
        card = engine.extract(two)
        card_cands = [p.out for p in engine.ocr_processors]
        cpu = cpu_engine.extract(two)
        cpu_cands = [p.out for p in cpu_engine.ocr_processors]
    finally:
        del engine._detect_pages
    equal, flips, other, score_err = _vote_compare(card, cpu, list(zip(*card_cands)),
                                                   list(zip(*cpu_cands)))
    emit({"phase": "best", "pages": n, "page_hw": [h, w], "trees": engine.trained,
          "first_call_s": first_s, "wall_ms_per_page": wall / n * 1e3, "words": words,
          "golden_words": sum(len(r["words"]) for r in golden["pages"]),
          "votes_by_confidence": by_confidence, "alone": alone, "launches": launches,
          "word_request": {"equal": word_equal, "score_err": word_err,
                           "text": [wd["text"] for wd in word[0]["words"]]},
          "cpu_check": {"pages": len(two), "detection_lines_equal": same_lines,
                        "detection_boxes_moved": moved, "moved_least_iou": least_iou,
                        "box_iou_limit": BOX_IOU_LIMIT,
                        "boxes_lines_equal": equal, "flips": flips,
                        "other_differences": other[:5], "n_other": len(other),
                        "score_err": score_err, "score_limit": BF16_SCORE_LIMIT,
                        "s": time.perf_counter() - t0},
          **row})
    if not row["within_limits"]:
        raise AssertionError(f"the best run is outside the golden's limits: {row}")
    if not (word_equal and word_err <= BF16_SCORE_LIMIT):
        raise AssertionError(f"the WORD request differs from its golden: {word}")
    if not (same_lines and least_iou >= BOX_IOU_LIMIT):
        raise AssertionError(f"card and CPU detections differ: lines equal {same_lines}, "
                             f"{moved} boxes moved, least IoU {least_iou}")
    if not (equal and not other and score_err <= BF16_SCORE_LIMIT):
        raise AssertionError(f"card and CPU disagree beyond counted flips: equal {equal}, "
                             f"{len(other)} other differences {other[:3]}, "
                             f"score error {score_err}")
    if (launches["crop_resize"].get("best", 0) <= 0
            or launches["flash_attention"].get("best", 0) <= 0):
        raise AssertionError(f"best run launches: {launches}")
    return engine, launches


def main() -> int:
    repo = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(repo, "marie_tpu_torch")):
        print("chip_smoke: marie_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, repo)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    phase_s = {}

    def run(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        phase_s[name] = round(phase_s.get(name, 0.0) + time.perf_counter() - t, 3)
        return out

    card = run("device", phase_device)
    run("k1", phase_k1)
    run("k1", phase_k1, 1, 128, "overflow_chunk")
    k1 = run("k1", phase_k1, SLICE_PAGES, SLICE_PAGES * 160, "serving")
    run("k1", phase_k1, 1, 128, "crnn_chunk", (32, 256), True)
    k2 = run("k2", phase_k2)
    run("small_reference", phase_small_reference)
    run("chain_reference", phase_chain_reference)
    run("precision", phase_precision)
    _, setups, pages = run("slice", phase_slice)
    run("stream", phase_stream, setups["heatmap"], pages)
    launches, chain_engines, chain_results = run("chain", phase_chain, setups, pages)
    run("layoutlm_base", phase_layoutlm_base, pages, chain_results)
    shipped = run("trained", load_shipped)
    trained_engine, trained_launches = run("trained", phase_trained, shipped)
    forms_launches = run("forms", phase_forms, trained_engine, shipped)
    best, best_launches = run("best", phase_best, shipped)
    run("profile", phase_profile,
        {"ink": (setups["ink"], pages), "heatmap": (setups["heatmap"], pages),
         "chain_heatmap": (chain_engines["heatmap"], pages),
         "trained": (trained_engine, shipped["pages"]),
         # two pages: tracing the best engine's ~8,700 launches a page
         # costs the profiler ~8 s a page
         "best": (best, list(shipped["pages"][:2]))})
    # the trained engine's 16-page run is the main path (OCR program and
    # chained heads); the forms phase adds the fragments path, the best
    # phase the voting engine's recognisers
    for row, name in ((k1, "crop_resize"), (k2, "flash_attention")):
        row["launches"] = trained_launches[name]["all"]
        row["launches_by_path"] = {
            **{k: v for k, v in trained_launches[name].items() if k != "all"},
            "fragments": forms_launches[name].get("fragments", 0),
            "best": best_launches[name].get("best", 0)}
    emit({"phase": "done", "wall_s": round(time.perf_counter() - t0, 3), "phase_s": phase_s})
    print(card, flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "launches_by_path",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{k: row[k] for k in keys} for row in (k1, k2)]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
