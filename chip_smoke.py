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
against the truth, its JAX golden and the CPU path (``best``); runs the
classification pipeline (OCR, classify, split, with its OCR cache) at
LayoutLMv3-base width on the shipped pages against its JAX golden, cold
and cached, and the layout embeddings against the CPU and JAX
(``classify``); runs the extract pipeline (overlay cleanup, OCR, classify
and index, the text, PDF, BLOBS and Adlib renderers, pack) against its
JAX golden on replayed OCR, as bench's ``full_pipeline`` job twice on 16
pages with 4 made dirty, again with base-width heads, and its pix2pix
generator alone at full width (``extract``); runs the boundary
registration (the deskew sweep and the full-width corner regressor) and
the NCC, DIM and VQNNF template matchers against their JAX golden and the
CPU, and the ``full_pipeline`` job with both stages on (``register``);
runs the other word detectors against their JAX golden and the CPU: the
weight-free ink detector in the engine on the shipped pages, the DiT
detector at ``dit_synth_s1`` width and its no-tree configuration and
TextFuseNet at ``synth_s2`` (seeded weights), and the trained engine
under each CC stats variant (``detectors``); orders the golden OCR words
of the shipped pages and a 600-word page with the reading-order model at
full width (seeded; K2 float32 at D=32) against its JAX golden, and the
trained engine's results card against CPU (``reading_order``); trains
on the card: K2's gradient kernel against autograd of its plain version
at the trainers' shapes, one AdamW step card against CPU, the splitter,
the chained heads and the reading-order ranker at their scripts'
settings, each held to the JAX-trained tree's held-out figures
(``golden_train.json``) less 0.03, and 5 steps at LayoutLMv3-base width
(``train``); trains the OCR models on renders of the glyph atlas: K2 and
its gradient at the recognizer's shapes, one step card against CPU of the
recognizer, the CRNN and CRAFT (float64), warm starts of the three zoo
trees held to ``golden_train.json``'s held-out figures measured on PIL's
renders (CRAFT also in the engine on the 16 pages), and an untrained
recognizer's first steps (``ocr_train``); checks the runtime glue (``mesh="local"``, ``TimeContextTPU``, the system
metrics, the version table, and the numpy JPEG and G4 codecs against
PIL's digests) (``runtime``); holds the rotated IoU, NMS and ROIAlign
and the deformable convolution to the CPU (``rotated``); runs the
single-page program (``fused_dispatch``) on 2 shipped pages against the
golden (``single``); serves the OCR executor from a worker pod over HTTP,
answers 8 two-page requests one at a time and then all in flight against
the golden and an in-process pipeline, and runs the NER executor through
the worker's handler (``serve``); serves the OCR executor over the
port's gRPC plane, from a server in this process (health, dry_run,
status, discovery; the 8 requests one at a time in both wire modes
against the HTTP answers, with K1 and K2 counted on ``"fused"``, then all
in flight on one channel and through the bidirectional ``Call``) and
from a ``Flow`` of gateway, head and two worker pods (all in flight, the
error envelope, a deadline, the children gone on close) (``grpc``);
boots the server shell from YAML through the CLI (``python -m
marie_tpu_torch.cli server --start --uses <yml>``) in a child process,
with the workers' warm-up, and drives its REST
control plane: a job, the 8 requests as 2-page TIFFs against the
``serve`` answers with K1 and K2 counted on ``"fused"`` in the workers (the
warm-up's apart), a NER request, SIGTERM (``server``); serves one gateway
on gRPC, HTTP and WebSocket at once with its worker pod from the
discovery registry: the 8 requests in flight on one WebSocket, pairs over
HTTP and gRPC, a W3C trace across the gRPC hops, the worker's kernels
counted on its monitoring port, the Sagemaker app, the worker's
deregistration on close (``gateway``); serves three RAFT replicas of the
OCR worker from a hub bundle (``stateful``); splits the trained engine's
page group over a local mesh of two entries of the card and trains the
serving recogniser on worlds (2, 1) and (1, 2) of two ranks, against the
unsplit and one-rank runs, with the pipeline, expert and sequence legs
and a one-rank NCCL world (``parallel``);
traces one more
run per
box source, of the chained engine, of the trained engine, of the
``best`` engine, of the extract job and its generator and of the job
with both stages, with torch.profiler (``profile``).  It prints one JSON
line per phase; the last two lines are the kernel table and
``{"ok": true, "device": {...}}``.  Every phase raises on failure; the
script exits nonzero, with no result line, without a CUDA device or
without the package beside it.  It imports nothing of JAX.
"""

import contextlib
import functools
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
EMBEDDINGS = "page word counts"
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
    # LayoutEmbeddingsModel at base width on the 16 shipped pages' texts
    # (text only, padded to 512 tokens; kv_len = each page's word count)
    ("embeddings_fp32", (16, 12, 512, 512, 64), "fp32", False, EMBEDDINGS, True),
    # the base indexer of the extract phase on a shipped page: one window
    # of 512, kv_len = page 0's word count
    ("layoutlm_base_ner_page_fp32", (1, 12, 512, 512, 64), "fp32", False, EMBEDDINGS, True),
    # the DiT detector's encoder on one page: dit_synth_s1 (512x384 in
    # 16x16 patches) and the no-tree configuration (1024x768)
    ("dit_s1_fp32", (1, 4, 768, 768, 64), "fp32", False, None, True),
    ("dit_default_fp32", (1, 6, 3072, 3072, 64), "fp32", False, None, True),
    # the DiT trainer's step (dit_synth_s1, batch 8): the forward it
    # differentiates (ocr_train times the gradient)
    ("dit_train_fp32", (8, 4, 768, 768, 64), "fp32", False, None, True),
    # the reading-order model at base width on one page band: 256 boxes
    # padded, kv_len = page 0's word count
    ("reading_order_fp32", (1, 4, 256, 256, 32), "fp32", False, EMBEDDINGS, True),
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


def _page_word_counts(b: int, cap: int):
    """kv_len of the embeddings' batch: the word counts of the first ``b``
    shipped pages in the golden (the texts ``phase_classify`` embeds),
    capped at ``cap`` tokens."""
    import torch

    from marie_tpu_torch.registry.zoo import open_zoo_json

    with open_zoo_json("golden") as f:
        pages = json.load(f)["pages"][:b]
    if len(pages) != b:
        raise AssertionError(f"{len(pages)} golden pages, not {b}")
    return torch.tensor([min(len(p["words"]), cap) for p in pages], dtype=torch.int32,
                        device="cuda")


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
    of ``phase_layoutlm_base``'s 1,200-word page), and the base-width
    layout embeddings of the 16 shipped pages' texts (512 tokens, kv_len
    the pages' word counts), and the base indexer on one shipped page
    (the extract phase's shape: one window, kv_len its word count), the
    DiT encoder's two shapes, and the reading-order model's band (D=32:
    4 heads, 256 boxes, kv_len page 0's word count).  Times
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
        elif kv_min == EMBEDDINGS:
            kv_len = _page_word_counts(b, skv)
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
    from marie_tpu_torch.ops.kernels.flash_attention import (
        flash_attention,
        flash_attention_backward,
    )

    _build.reset_counts(crop_resize, flash_attention, flash_attention_backward)


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
    the ``trained`` engine, the ``best`` engine on one page, a first pass
    of the ``extract`` phase's ``full_pipeline`` job on its last 8 pages
    and its generator on the 4 dirty pages; ``slice``'s and ``chain``'s
    seeded engines, the job with both optional stages and the
    ``detectors`` engines are not traced again: their breakdowns stand
    from the runs of the PRs that ported them), on every thread; wall
    time,
    device busy time, the
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
    Returns (the heatmap run's launches, the heatmap run's results)."""
    import torch

    from marie_tpu_torch.ocr.ocr_engine import PipelineOcrEngine

    n, h, w = pages.shape
    cls, ner = chain_heads("cuda")
    launches, results = None, None
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
    return launches, results


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
    return cls_tree, ner_tree


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


#: the grays of the JAX package's overlay trainer (``_OVERLAY_COLORS`` of
#: ``marie_tpu/train/overlay.py``); shaded fills take the palest
OVERLAY_GRAYS = (160, 120, 190)
#: the shipped pages made dirty for the ``extract`` phase, and their seed
DIRTY_PAGES = (12, 13, 14, 15)
DIRTY_SEED = SEED + 40


def dirty_pages(pages, seed: int = DIRTY_SEED):
    """Gray pages with form overlays drawn under their text, as
    ``render_overlay_pair`` draws them on its 512x384 pages (sizes scaled
    to the page's height): 2-7 horizontal rules 1-3 px thick, 0-3
    vertical rules, 1-4 box outlines, 1-3 shaded fills and 0-3 dotted
    lines (4 px dashes every 8 px), in ``OVERLAY_GRAYS``.  The text stays
    on top: each pixel keeps the darker of the page and the overlay.
    numpy only, from ``np.random.default_rng(seed)``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for page in pages:
        h, w = page.shape
        k = h / 512.0
        ov = np.full((h, w), 255, np.uint8)

        def ri(lo, hi):
            return int(rng.integers(int(lo), max(int(hi), int(lo) + 1)))

        def gray():
            return OVERLAY_GRAYS[ri(0, len(OVERLAY_GRAYS))]

        def paint(y0, y1, x0, x1, g):
            ov[y0:y1, x0:x1] = np.minimum(ov[y0:y1, x0:x1], g)

        for _ in range(ri(2, 8)):
            y = ri(0, h)
            paint(y, y + ri(1, 4), 0, w, gray())
        for _ in range(ri(0, 4)):
            x = ri(0, w)
            paint(0, h, x, x + ri(1, 3), gray())
        for _ in range(ri(1, 5)):
            x0, y0 = ri(0, w - 60 * k), ri(0, h - 40 * k)
            x1 = min(x0 + ri(50 * k, 220 * k), w - 1)
            y1 = min(y0 + ri(25 * k, 120 * k), h - 1)
            t, g = ri(1, 3), gray()
            paint(y0, y0 + t, x0, x1 + 1, g)
            paint(y1 - t + 1, y1 + 1, x0, x1 + 1, g)
            paint(y0, y1 + 1, x0, x0 + t, g)
            paint(y0, y1 + 1, x1 - t + 1, x1 + 1, g)
        for _ in range(ri(1, 4)):
            x0, y0 = ri(0, w - 80 * k), ri(0, h - 40 * k)
            paint(y0, min(y0 + ri(20 * k, 90 * k), h), x0, min(x0 + ri(60 * k, 240 * k), w),
                  max(OVERLAY_GRAYS))
        for _ in range(ri(0, 4)):
            y, g = ri(0, h), gray()
            for x in range(0, w, 8):
                paint(y, y + 1, x, x + 4, g)
        out.append(np.minimum(page, ov))
    return out


def asset_digest(root: str) -> dict:
    """What the extract pipeline left under an asset directory, by the
    golden's measure: the listing relative to ``root``, sha256 of
    ``results.txt``, of each BLOBS XML, of each Adlib XML with its
    ``CreationDate`` blanked, and of each PDF page's inflated content
    stream."""
    import hashlib
    import re

    from marie_tpu_torch.renderer.pdf_renderer import read_pdf

    def read(rel):
        with open(os.path.join(root, rel), "rb") as f:
            return f.read()

    def sha(data):
        return hashlib.sha256(data).hexdigest()

    listing = sorted(os.path.relpath(os.path.join(base, f), root)
                     for base, _, files in os.walk(root) for f in files)
    out = {"assets": listing, "results.txt": sha(read("results.txt"))}
    for rel in listing:
        if rel.startswith("blobs" + os.sep):
            out[rel] = sha(read(rel))
        elif rel.startswith("adlib" + os.sep):
            out[rel] = sha(re.sub(rb'(FIELD="CreationDate" VALUE=")[^"]*"', rb'\1"', read(rel)))
    out["pdf_content"] = [sha(p["content"]) for p in read_pdf(read("results.pdf"))]
    return out


#: the ``register`` phase's inputs: skew angles, scans and templates
#: from this seed
REGISTER_SEED = SEED + 50
#: shipped pages placed into scanner canvases for the boundary model
SCAN_PAGES = (0, 5, 10, 15)
#: (page, truth word) of the template crops; one more template is noise
TEMPLATE_WORDS = ((0, 0), (3, 2), (7, 5), (11, 1))


def skew_angles(n: int):
    """n skew angles in degrees, uniform in [-5, 5], float32."""
    import numpy as np

    return np.random.default_rng(REGISTER_SEED).uniform(-5.0, 5.0, n).astype(np.float32)


def skewed_pages(pages, device: str):
    """The shipped gray pages as RGB, each rotated by its ``skew_angles``
    angle with the port's warp (``rotate_page``, bilinear, white
    corners), uint8 [H, W, 3] on the host."""
    import numpy as np
    import torch

    from marie_tpu_torch.components.document_registration.boundary import rotate_page
    from marie_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    return [rotate_page(torch.from_numpy(np.stack([p] * 3, axis=-1)).to(dev),
                        np.float32(np.radians(a))).cpu().numpy()
            for p, a in zip(pages, skew_angles(len(pages)))]


def scans(pages, device: str):
    """``SCAN_PAGES`` placed into 1024x768 scanner canvases by the port's
    ``composite_scan`` (the JAX trained-boundary test's recipe at full
    size): a quad inset 4-16% with 12 px of normal jitter, background 40
    plus uniform noise in [-10, 10], from ``REGISTER_SEED``.  Returns
    [(scan uint8 [H, W, 3], quad [4, 2])]."""
    import numpy as np

    from marie_tpu_torch.models.boundary import composite_scan

    rng = np.random.default_rng(REGISTER_SEED + 1)
    out = []
    for i in SCAN_PAGES:
        page = pages[i]
        h, w = page.shape
        quad = (np.asarray([[0.16, 0.13], [0.88, 0.08], [0.84, 0.91], [0.06, 0.87]])
                * [w, h] + rng.normal(0, 12, (4, 2))).astype(np.float32)
        noise = rng.uniform(-10, 10, (h, w)).astype(np.float32)
        scan = composite_scan(np.stack([page] * 3, axis=-1), quad, (h, w), 40.0, noise,
                              device=device)
        out.append((scan.cpu().numpy(), quad))
    return out


def register_templates(shipped):
    """[(label, uint8 image)]: ``TEMPLATE_WORDS`` cut from the shipped
    pages by their truth boxes, and a noise patch on no page."""
    import numpy as np

    out = []
    for page, word in TEMPLATE_WORDS:
        text, (x, y, w, h) = shipped["truth"]["pages"][page][word]
        out.append((f"p{page}w{word}:{text}", shipped["pages"][page][y:y + h, x:x + w]))
    noise = np.random.default_rng(REGISTER_SEED + 2).integers(0, 256, (24, 64), dtype=np.uint8)
    out.append(("noise", noise))
    return out


def match_rows(results):
    """Matches as [frame, label, [x, y, w, h], score] rows."""
    return [[m.frame_index, m.label, list(m.bbox), float(m.score)] for m in results]


class ReplayOcr:
    """An OCR engine that answers with given result dicts (copies), page by
    page: the extract pipeline's OCR stage without a model."""

    def __init__(self, results):
        self.results = results

    def extract(self, frames, pms_mode=None, coordinate_format=None, **kwargs):
        import copy

        return copy.deepcopy(self.results[:len(frames)])


def load_shipped():
    """The pages, truth and golden of ``torch_zoo/`` (made with the JAX
    package by ``scripts/export_torch_zoo.py``); missing files fail."""
    import numpy as np

    from marie_tpu_torch.registry.zoo import ZOO_DIR, open_zoo_json

    with np.load(os.path.join(ZOO_DIR, "pages.npz")) as data:
        shipped = {k: data[k] for k in data.files}
    for name in ("truth", "golden"):
        with open_zoo_json(name) as f:
            shipped[name] = json.load(f)
    return shipped


def zoo_engine(device: str, cpu_bf16_rounding: str = "xla"):
    """``bench.py``'s serving engine over the zoo's trained trees, with the
    chained heads: the registry's loaders (``ocr/util.py``) with bench's
    settings (256 components, CC run budget 32, chunks of 32/128/256, u2,
    160 rows a page, 16-page groups).  On the CPU the bf16 detector rounds
    as ``cpu_bf16_rounding`` says: as XLA's CPU (the golden's), or as
    torch's modules (the card's).  Fails unless all four trees load."""
    from marie_tpu_torch.components.document_classifier import LayoutDocumentClassifier
    from marie_tpu_torch.components.document_indexer import LayoutDocumentIndexer
    from marie_tpu_torch.ocr.ocr_engine import PipelineOcrEngine
    from marie_tpu_torch.ocr.util import craft_box_processor, trocr_processor

    engine = PipelineOcrEngine(
        craft_box_processor(256, cc_runs=32, device=device,
                            cpu_bf16_rounding=cpu_bf16_rounding),
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
    # equal page labels where every word agrees, equal NER labels on the
    # pages whose boxes all equal the golden's (the heads see the same
    # words there); the NER share over all pages is reported
    ok = (row["agreement"]["words"] >= TEXT_AGREEMENT and not row["agreement"]["label_pages"]
          and not row["agreement"]["ner_pages"])
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
    path on the same trees, rounding where the card rounds
    (``zoo_engine("cpu", "torch")``: equal words, boxes,
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
    cpu_engine = zoo_engine("cpu", cpu_bf16_rounding="torch")

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


def best_engine(device: str, cpu_bf16_rounding: str = "xla"):
    """The registry's ``best`` engine (CRAFT, TrOCR beam-5, CRNN from the
    zoo) with its recognisers wrapped in ``_Candidates``; on the CPU its
    bf16 detector rounds as ``cpu_bf16_rounding`` says (see
    ``zoo_engine``).  Fails unless every tree loads."""
    from marie_tpu_torch.ocr.util import get_known_ocr_engines

    engine = get_known_ocr_engines(device, "best")["best"]
    engine.box_processor.model.set_cpu_bf16_rounding(cpu_bf16_rounding)
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
    two pages (the CPU's bf16 detector rounding where the card's does):
    the detections (equal box counts and lines; boxes the
    bf16 detector moves are counted and keep IoU >= BOX_IOU_LIMIT), then
    both sides' recognisers and vote on the card's detections: equal
    result dicts apart from texts and scores, equal texts apart from
    counted flips (``_vote_compare``), scores within BF16_SCORE_LIMIT.
    Returns (engine, launches of the second call)."""
    import torch

    from marie_tpu_torch.enums import PSMode
    from marie_tpu_torch.ocr.voting_ocr_engine import VotingOcrEngine
    from marie_tpu_torch.registry.zoo import open_zoo_json

    with open_zoo_json("golden_best") as f:
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
    cpu_engine = best_engine("cpu", cpu_bf16_rounding="torch")
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


#: card against the JAX golden (float32 heads at base width: 3-decimal
#: agreement, as the float32 engines' card vs CPU scores) and card
#: against CPU or JAX embeddings (float32 through 12 layers)
CLASSIFY_SCORE_LIMIT = 1e-3
EMBED_LIMIT = 1e-4
CLASSIFY_PASSES = ("cold", "cached_1", "cached_2")


def _time_calls(obj, method: str, stage: str, times: dict) -> None:
    """Wrap ``obj.method`` so that each call adds its host ms, to a
    synchronised card, to ``times[stage]``."""
    import torch

    fn = getattr(obj, method)

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        times[stage] = times.get(stage, 0.0) + (time.perf_counter() - t) * 1e3
        return out

    setattr(obj, method, timed)


def _classify_rows(meta):
    """(labels, scores, split labels, split scores, boundaries, documents)."""
    return ([p["classification"] for p in meta["page_classifier"]],
            [p["score"] for p in meta["page_classifier"]],
            [p["label"] for p in meta["splitter"]], [p["score"] for p in meta["splitter"]],
            [p["is_boundary"] for p in meta["splitter"]], meta["documents"])


def phase_classify(shipped, trained_engine, cls_tree):
    """The classification pipeline (``ClassificationPipeline``: OCR,
    page classification, split into documents) with the classifier at
    LayoutLMv3-base width (``base(3)``, image branch; ``layoutlm_base``'s
    tree) and the splitter at ``base(2)``, seeded as
    ``torch_zoo/golden_classify.json`` states:

    * (a) on the 16 shipped pages with the golden's ``ocr_results`` (no
      OCR): labels, split and documents equal the JAX golden, scores
      within CLASSIFY_SCORE_LIMIT;
    * (b) on the same pages with the trained serving engine (the trained
      trees of ``trained``, no chained heads) in a fresh ``work_dir``: a
      cold pass (OCR, then ``results/ocr.json``) and two passes that read
      the cache; pages/s, ms/page and stage ms (ocr, classify, split) of
      each, K1/K2 launches by path (the cached passes launch nothing on
      ``"fused"`` and K2 on ``"heads"``), and the labels' agreement with
      (a), reported (card OCR moves a few boxes);
    * (c) ``LayoutEmbeddingsModel`` at base width on the 16 pages' texts:
      ms per call, K2 launches on ``"embeddings"``, the first 4 rows
      against the CPU and against the golden's JAX vectors within
      EMBED_LIMIT.

    Returns the launches of (b)'s passes and (c)'s call."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from marie_tpu_torch.components.document_classifier import LayoutDocumentClassifier
    from marie_tpu_torch.components.document_splitter import LayoutDocumentSplitter
    from marie_tpu_torch.embeddings import LayoutEmbeddingsModel
    from marie_tpu_torch.models.configs import LayoutLMConfig
    from marie_tpu_torch.ocr.ocr_engine import PipelineOcrEngine
    from marie_tpu_torch.pipe import ClassificationPipeline
    from marie_tpu_torch.registry.convert import init_flax_layout
    from marie_tpu_torch.registry.zoo import open_zoo_json

    with open_zoo_json("golden_classify") as f:
        golden = json.load(f)
    seeds, labels = golden["settings"]["seeds"], tuple(golden["settings"]["labels"])
    if seeds["classifier"] != SEED + 10:
        raise AssertionError(f"golden classifier seed {seeds['classifier']} is not "
                             f"layoutlm_base's {SEED + 10}")
    frames, ocr = list(shipped["pages"]), shipped["golden"]["pages"]
    n, (h, w) = len(frames), frames[0].shape
    t0 = time.perf_counter()
    cls = LayoutDocumentClassifier(labels, LayoutLMConfig.base(3), cls_tree, device="cuda")
    split_cfg = LayoutLMConfig.base(2)
    splitter = LayoutDocumentSplitter(
        config=split_cfg, params=init_flax_layout(split_cfg, seeds["splitter"], "sequence"),
        device="cuda")
    engine = PipelineOcrEngine(trained_engine.box_processor, trained_engine.ocr_processor,
                               upload_format="u2", compact_slots=160, page_fuse_batch=16)
    stage_ms: dict = {}
    _time_calls(engine, "extract", "ocr", stage_ms)
    _time_calls(cls, "predict", "classify", stage_ms)
    _time_calls(splitter, "split", "split", stage_ms)
    row = {"phase": "classify", "pages": n, "page_hw": [h, w], "seeds": seeds,
           "score_limit": CLASSIFY_SCORE_LIMIT, "setup_s": time.perf_counter() - t0}

    with tempfile.TemporaryDirectory() as work_dir:
        # (a) the golden's OCR results: the heads alone against JAX
        pipe = ClassificationPipeline(classifiers=[cls], splitter=splitter,
                                      work_dir=os.path.join(work_dir, "a"))
        got = _classify_rows(pipe.execute("shipped", "classify", frames, ocr_results=ocr))
        want = _classify_rows(golden)
        score_err = max(float(np.abs(np.subtract(got[i], want[i])).max()) for i in (1, 3))
        equal = (got[0] == want[0] and got[2] == want[2] and got[4:] == want[4:])
        row["golden_inputs"] = {"equal_labels_split_documents": equal,
                                "max_score_err": score_err,
                                "labels": sorted(set(got[0])), "documents": len(got[5])}
        if not equal or not score_err <= CLASSIFY_SCORE_LIMIT:
            emit(row)
            raise AssertionError(f"classify on the golden's OCR differs from JAX: {row}")

        # (b) the whole bundle: a cold pass, then two passes on the cache
        pipe = ClassificationPipeline(ocr_engine=engine, classifiers=[cls], splitter=splitter,
                                      work_dir=os.path.join(work_dir, "b"))
        passes, launches = {}, {}
        for name in CLASSIFY_PASSES:
            stage_ms.clear()
            _reset_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            meta = pipe.execute("shipped", "classify", frames)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            launches[name] = _read_counts()
            passes[name] = {"wall_ms": wall * 1e3, "ms_per_page": wall / n * 1e3,
                            "pages_per_s": n / wall, "stage_ms": dict(stage_ms),
                            "documents": len(meta["documents"]), "launches": launches[name]}
            if name == "cold":
                _check_results(meta["ocr"], n, h, w)
            mine = _classify_rows(meta)
            passes[name]["label_agreement_with_a"] = float(np.mean(
                [a == b for a, b in zip(mine[0], got[0])]))
            passes[name]["split_agreement_with_a"] = float(np.mean(
                [a == b for a, b in zip(mine[4], got[4])]))
        cache = os.path.join(work_dir, "b", os.listdir(os.path.join(work_dir, "b"))[0],
                             "results", "ocr.json")
        row["bundle"] = {"passes": passes, "ocr_cache_bytes": os.path.getsize(cache)}
    cold, cached = launches["cold"], [launches[p] for p in CLASSIFY_PASSES[1:]]
    ok = (cold["crop_resize"].get("fused", 0) > 0 and cold["flash_attention"].get("fused", 0) > 0
          and "ocr" in passes["cold"]["stage_ms"]
          and all(c[k].get("fused", 0) == 0 for c in cached for k in c)
          and all(c["flash_attention"].get("heads", 0) > 0 for c in cached)
          and not any("ocr" in passes[p]["stage_ms"] for p in CLASSIFY_PASSES[1:]))

    # (c) the layout embeddings of the pages' texts
    texts = [" ".join(wd["text"] for wd in page["words"]) for page in ocr]
    t = time.perf_counter()
    embed_cfg = dataclasses.replace(LayoutLMConfig.base(), use_image=False)
    embed_tree = init_flax_layout(embed_cfg, seeds["embeddings"], "encoder")
    card = LayoutEmbeddingsModel(LayoutLMConfig.base(), embed_tree, device="cuda")
    setup_s = time.perf_counter() - t
    ms, _ = _ms_per_call(lambda: card.get_embeddings(texts))
    _reset_counts()
    vectors = card.get_embeddings(texts)
    torch.cuda.synchronize()
    launches["embeddings"] = _read_counts()
    k = len(golden["embeddings"])
    t = time.perf_counter()
    cpu = LayoutEmbeddingsModel(LayoutLMConfig.base(), embed_tree,
                                device="cpu").get_embeddings(texts[:k])
    errs = {"cpu": float(np.abs(vectors[:k] - cpu).max()),
            "jax": float(np.abs(vectors[:k] - np.asarray(golden["embeddings"])).max())}
    row["embeddings"] = {"texts": len(texts), "dim": int(vectors.shape[1]),
                         "ms_per_call": ms, "setup_s": setup_s,
                         "cpu_check_s": time.perf_counter() - t, "checked_rows": k,
                         "max_abs_err": errs, "limit": EMBED_LIMIT,
                         "norms": [float(np.linalg.norm(v)) for v in vectors[:2]],
                         "launches": launches["embeddings"]}
    emit(row)
    if not ok:
        raise AssertionError(f"classify bundle launches or stages: {row['bundle']}")
    if not (np.isfinite(vectors).all() and vectors.shape == (n, 768)
            and max(errs.values()) <= EMBED_LIMIT
            and launches["embeddings"]["flash_attention"].get("embeddings", 0) > 0):
        raise AssertionError(f"embeddings: {row['embeddings']}")
    return launches


#: ``extract``: the heads against golden_extract.json (float32 at base
#: width, as classify); the generator card against CPU in float32
#: (blended pixels equal in >= 99.9%: a float32 value on a rounding
#: boundary of ``clip((fake + 1) * 127.5)`` moves a pixel by one level);
#: the card's float32 generator against the JAX golden's per-page counts:
#: mask and changed pixels within 16, the page's sum within 5e-6 of it
#: (measured on an NVIDIA H100 80GB HBM3 at 700 W: within 2 pixels and 72
#: of ~1.1e8; the bfloat16 generator's counts, reported beside them, are
#: the control that these limits tell apart); bfloat16 against float32
#: on the card: masks equal in >= 99.9%, pixels within 4 levels in
#: >= 99.98% (measured there: 99.957% and 99.9957%)
EXTRACT_SCORE_LIMIT = 1e-3
GAN_CPU_EQUAL = 0.999
GAN_COUNT_LIMIT = 16
GAN_SUM_LIMIT = 5e-6
GAN_BF16_MASK_EQUAL = 0.999
GAN_BF16_WITHIN_4 = 0.9998
#: the two passes of bench's full_pipeline job in one work dir
EXTRACT_PASSES = ("pass_1", "pass_2")


def _off_golden(masks, blended, dirty, golden) -> dict:
    """Per page, how far the generator's mask pixels, changed pixels and
    blended sum lie from the JAX golden's; within GAN_COUNT_LIMIT pixels
    and GAN_SUM_LIMIT of the sum, or not."""
    import numpy as np

    off, ok = [], True
    for g, m, b, d in zip(golden, masks, blended, dirty):
        o = {"page": g["page"], "mask_pixels": int((m > 0).sum()) - g["mask_pixels"],
             "changed_pixels": int((b != d).sum()) - g["changed_pixels"],
             "sum": int(b.astype(np.int64).sum()) - g["sum"]}
        ok = ok and (abs(o["mask_pixels"]) <= GAN_COUNT_LIMIT
                     and abs(o["changed_pixels"]) <= GAN_COUNT_LIMIT
                     and abs(o["sum"]) <= GAN_SUM_LIMIT * g["sum"])
        off.append(o)
    return {"off_by": off, "within_limits": ok}


def _gan_flops(cfg, h: int, w: int) -> int:
    """Operations (2 per multiply-add) of one generator forward on an
    [h, w] input: 7x7 in, two stride-2 3x3 downs, the resnet blocks, two
    stride-2 3x3 transposed ups (counted on their inputs), 7x7 out."""
    f, n = cfg.base_channels, cfg.num_res_blocks
    ops = 49 * cfg.in_channels * f * h * w
    ops += 9 * f * 2 * f * (h // 2) * (w // 2) + 9 * 2 * f * 4 * f * (h // 4) * (w // 4)
    ops += 2 * n * 9 * (4 * f) ** 2 * (h // 4) * (w // 4)
    ops += 9 * 4 * f * 2 * f * (h // 4) * (w // 4) + 9 * 2 * f * f * (h // 2) * (w // 2)
    ops += 49 * f * cfg.out_channels * h * w
    return 2 * ops


def _pdf_words(pdf_path):
    """Each page's invisible text, as the words of its ``(text) Tj`` ops."""
    import re

    from marie_tpu_torch.renderer.pdf_renderer import read_pdf

    with open(pdf_path, "rb") as f:
        pages = read_pdf(f.read())
    unescape = re.compile(rb"\\(.)")
    return [[unescape.sub(rb"\1", m.group(1)).decode("latin-1")
             for m in re.finditer(rb"\((.*?)(?<!\\)\) Tj", p["content"])] for p in pages]


def _extract_pass(pipe, frames, ref_id, overlay, stage: str):
    """One ``execute`` to a synchronised card: (metadata, row)."""
    import torch

    calls = overlay.calls
    _reset_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    meta = pipe.execute(ref_id, "bench_pdf", list(frames), job_id=stage)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    row = {"wall_ms": wall * 1e3, "ms_per_page": wall / len(frames) * 1e3,
           "pages_per_s": len(frames) / wall, "stage_times_s": meta["stage_times_s"],
           "generator_calls": overlay.calls - calls, "launches": _read_counts()}
    return meta, row


def _check_bundle(meta, root, frames, dirty_idx, prefix):
    """What a pass left: results.tif equal to clean/ (the pages the gate
    passed unchanged equal to the input, the dirty ones cleaned), a
    16-page PDF whose text layer holds each page's OCR words, and the
    packed assets (a pack that failed quietly fails here)."""
    import zipfile

    import numpy as np

    from marie_tpu_torch.utils.image_io import read_png, read_tiff

    n = len(frames)
    tif = read_tiff(os.path.join(root, "results.tif"))
    clean = [read_png(os.path.join(root, "clean", name))
             for name in sorted(os.listdir(os.path.join(root, "clean")))]
    if len(tif) != n or len(clean) != n or not all(
            np.array_equal(t, c) for t, c in zip(tif, clean)):
        raise AssertionError("results.tif is not the clean pages")
    for i, (t, f) in enumerate(zip(tif, frames)):
        if np.array_equal(t, f) == (i in dirty_idx):
            raise AssertionError(f"page {i}: cleaned {i in dirty_idx} but "
                                 f"{'unchanged' if np.array_equal(t, f) else 'changed'}")
    words = _pdf_words(os.path.join(root, "results.pdf"))
    want = [[w["text"] for w in page["words"] if w["text"]] for page in meta["ocr"]]
    if len(words) != n or words != want:
        raise AssertionError("the PDF's text layer is not the OCR's words")
    assets = os.path.join(root, "assets")
    names = sorted(os.listdir(assets))
    expect = sorted(f"{prefix}{ext}" for ext in (".blobs.xml.zip", ".ocr.zip", ".pdf", ".tif",
                                                 ".tif.clean"))
    with zipfile.ZipFile(os.path.join(assets, f"{prefix}.ocr.zip")) as z:
        adlib = len(z.namelist())
    with zipfile.ZipFile(os.path.join(assets, f"{prefix}.blobs.xml.zip")) as z:
        blobs = len(z.namelist())
    if not set(expect) <= set(names) or adlib != n + 1 or blobs != n:
        raise AssertionError(f"packed assets: {names}, {adlib} Adlib and {blobs} BLOBS files")
    return {"pdf_pages": len(words), "pdf_words": sum(map(len, words)), "assets": len(names)}


class _Calls:
    """An ``extract(pages)`` for ``phase_profile`` over another call."""

    def __init__(self, fn):
        self.extract = fn


def _full_pipeline_pass(engine, overlay):
    """One first pass of bench's ``full_pipeline`` job in a fresh work
    dir (the overlay runs), as an ``extract(pages)``."""
    import tempfile

    from marie_tpu_torch.pipe import ExtractPipeline

    def run(pages):
        with tempfile.TemporaryDirectory() as work_dir:
            return ExtractPipeline(ocr_engine=engine, classifiers=[], indexers=[],
                                   work_dir=work_dir, overlay_processor=overlay,
                                   device="cuda").execute("bench0", "bench_pdf", list(pages))

    return _Calls(run)


def phase_extract(shipped, cls_tree, ner_tree):
    """The extract pipeline (``ExtractPipeline``: burst, overlay cleanup,
    OCR streamed to the renderers, classify and index, the text, PDF,
    BLOBS and Adlib renderers, pack, store) on the card:

    * (a) on the 16 shipped pages with the golden's OCR replayed, the
      classifier at ``base(3)`` and the indexer at ``base(5)`` (the trees
      of ``layoutlm_base``) and no overlay: labels, entities and the
      renderers' digest equal to ``torch_zoo/golden_extract.json``, scores
      within EXTRACT_SCORE_LIMIT;
    * (b) bench's ``full_pipeline`` job (``bench.py:388-437``):
      ``DefaultOcrEngine`` on the zoo's trained trees in bench's serving
      configuration, ``OverlayProcessor()`` at full width (seeded,
      bfloat16, ``gan_scale`` 2), no heads, on the 16 pages with 12-15
      made dirty (``dirty_pages``), twice in a fresh work dir: the gate
      sends the 4 dirty pages through the generator on the first pass;
      the second reads ``clean/`` and runs no generator.  pages/s,
      ms/page, stage seconds and launches of each; pages 0-11 against the
      truth and the golden (the golden's limits); ``results.tif``, the
      PDF and the packed assets checked (``_check_bundle``);
    * (c) (b) with the heads of (a): ``classify_index`` and K2 on
      ``"heads"``;
    * (d) the generator alone: bfloat16 ``segment_batch`` on the 4 dirty
      pages repeated to 16 (ms/page, TFLOP/s); float32 on the card
      against the CPU on 2 of them (GAN_CPU_EQUAL); float32 against the
      JAX golden's per-page counts (GAN_COUNT_LIMIT, GAN_SUM_LIMIT), and
      bfloat16's distance from them reported as the control; bfloat16
      against float32 on the card (GAN_BF16_MASK_EQUAL, GAN_BF16_WITHIN_4).

    Returns the launches by part and pass, and ``phase_profile``'s setups
    for a first pass of (b) and the generator on the 4 dirty pages."""
    import copy
    import io
    import tempfile

    import numpy as np
    import torch

    from marie_tpu_torch.components.document_classifier import LayoutDocumentClassifier
    from marie_tpu_torch.components.document_indexer import LayoutDocumentIndexer
    from marie_tpu_torch.models.configs import LayoutLMConfig, Pix2PixConfig
    from marie_tpu_torch.ocr.default_ocr_engine import DefaultOcrEngine
    from marie_tpu_torch.ocr.util import craft_box_processor, trocr_processor
    from marie_tpu_torch.overlay.overlay import OverlayProcessor, _segment_batch_gray
    from marie_tpu_torch.pipe import ExtractPipeline
    from marie_tpu_torch.registry.zoo import open_zoo_json
    from marie_tpu_torch.utils.image_io import encode_jpeg, write_png

    with open_zoo_json("golden_extract") as f:
        golden = json.load(f)
    settings = golden["settings"]
    if settings["seeds"]["classifier"] != SEED + 10 or settings["seeds"]["indexer"] != SEED + 11:
        raise AssertionError(f"golden seeds {settings['seeds']} are not layoutlm_base's")
    pages = list(shipped["pages"])
    n, (h, w) = len(pages), pages[0].shape
    t0 = time.perf_counter()
    cls = LayoutDocumentClassifier(tuple(settings["labels"]), LayoutLMConfig.base(3), cls_tree,
                                   device="cuda")
    ner = LayoutDocumentIndexer(tuple(settings["ner_labels"]), LayoutLMConfig.base(5), ner_tree,
                                device="cuda")
    row = {"phase": "extract", "pages": n, "page_hw": [h, w], "score_limit": EXTRACT_SCORE_LIMIT}
    launches = {}
    with tempfile.TemporaryDirectory() as work_dir:
        # (a) the golden's OCR: heads and renderers against JAX
        t = time.perf_counter()
        _reset_counts()
        pipe = ExtractPipeline(ocr_engine=ReplayOcr(shipped["golden"]["pages"]),
                               classifiers=[cls], indexers=[ner],
                               work_dir=os.path.join(work_dir, "a"), device="cuda")
        meta = pipe.execute("shipped.tif", "extract", pages)
        torch.cuda.synchronize()
        launches["golden"] = _read_counts()
        (checksum,) = os.listdir(os.path.join(work_dir, "a"))
        digest = asset_digest(os.path.join(work_dir, "a", checksum))

        def rows(pc, pi):
            return ([p["classification"] for p in pc],
                    [[(e["label"], list(e["word_span"]), e["text"]) for e in p["entities"]]
                     for p in pi])

        def scores(pc, pi):
            return [p["score"] for p in pc] + [e["score"] for p in pi for e in p["entities"]]

        got_scores = scores(meta["page_classifier"], meta["page_indexer"])
        want_scores = scores(golden["page_classifier"], golden["page_indexer"])
        equal = (rows(meta["page_classifier"], meta["page_indexer"])
                 == rows(golden["page_classifier"], golden["page_indexer"]))
        err = (float(np.abs(np.subtract(got_scores, want_scores)).max())
               if len(got_scores) == len(want_scores) else float("inf"))
        row["golden"] = {"equal_labels_entities": equal, "max_score_err": err,
                         "digest_equal": digest == golden["digest"],
                         "differing": sorted(k for k in golden["digest"]
                                             if digest.get(k) != golden["digest"][k]),
                         "entities": sum(len(p["entities"]) for p in meta["page_indexer"]),
                         "wall_s": time.perf_counter() - t, "launches": launches["golden"]}
        if not (equal and err <= EXTRACT_SCORE_LIMIT and digest == golden["digest"]):
            emit(row)
            raise AssertionError(f"extract on the golden's OCR differs from JAX: {row['golden']}")

        # (b) and (c): bench's full_pipeline job, without and with heads
        t = time.perf_counter()
        engine = DefaultOcrEngine(
            box_processor=craft_box_processor(256, cc_runs=32, device="cuda"),
            ocr_processor=trocr_processor(device="cuda", batch_sizes=(32, 128, 256)),
            upload_format="u2", compact_slots=160, page_fuse_batch=16, device="cuda")
        overlay = OverlayProcessor(device="cuda")
        row["setup_s"] = time.perf_counter() - t0
        row["engine_s"] = time.perf_counter() - t
        if (overlay.trained or overlay.config != Pix2PixConfig()
                or not all(engine.trained.values())):
            raise AssertionError(f"engine {engine.trained}, overlay trained {overlay.trained}")
        frames = list(pages)
        dirty = dirty_pages([pages[i] for i in DIRTY_PAGES])
        for i, d in zip(DIRTY_PAGES, dirty):
            frames[i] = d
        gate = [mid > 0.03 for _, mid in overlay.overlay_scores(frames)]
        row["gate_dirty"] = [i for i, g in enumerate(gate) if g]
        if row["gate_dirty"] != list(DIRTY_PAGES):
            raise AssertionError(f"the gate sent pages {row['gate_dirty']} to the generator")
        clean_golden = [{k: v for k, v in p.items() if k != "classification"}
                        for p in copy.deepcopy(shipped["golden"]["pages"][:DIRTY_PAGES[0]])]
        for p in clean_golden:
            for wd in p["words"]:
                wd.pop("ner_label", None)
                wd.pop("ner_score", None)
        for part, heads in (("full", False), ("heads", True)):
            pipe = ExtractPipeline(ocr_engine=engine, classifiers=[cls] if heads else [],
                                   indexers=[ner] if heads else [],
                                   work_dir=os.path.join(work_dir, part),
                                   overlay_processor=overlay, device="cuda")
            passes = {}
            for k, name in enumerate(EXTRACT_PASSES):
                meta, passes[name] = _extract_pass(pipe, frames, f"bench{k}", overlay, part)
                launches[f"{part}_{name}"] = passes[name]["launches"]
                (checksum,) = os.listdir(os.path.join(work_dir, part))
                passes[name]["bundle"] = _check_bundle(
                    meta, os.path.join(work_dir, part, checksum), frames, DIRTY_PAGES,
                    f"bench{k}")
                _check_results(meta["ocr"], n, h, w)
            passes["clean_pages"] = _against_golden(
                meta["ocr"][:DIRTY_PAGES[0]], clean_golden,
                shipped["truth"]["pages"][:DIRTY_PAGES[0]], (h, w))
            if heads:
                passes["labels"] = sorted({p["classification"] for p in meta["page_classifier"]})
                passes["entities"] = sum(len(p["entities"]) for p in meta["page_indexer"])
            row[part] = passes
            p1, p2 = passes["pass_1"], passes["pass_2"]
            ok = (p1["generator_calls"] == 1 and p2["generator_calls"] == 0
                  and passes["clean_pages"]["within_limits"]
                  and all(p["launches"]["crop_resize"].get("fused", 0) > 0
                          and p["launches"]["flash_attention"].get("fused", 0) > 0
                          for p in (p1, p2)))
            if heads:
                ok = ok and all(p["launches"]["flash_attention"].get("heads", 0) > 0
                                for p in (p1, p2))
            if not ok:
                emit(row)
                raise AssertionError(f"extract {part}: {passes}")

        # the host's file encoders on the 16 pages (render thread, clean/)
        host = {}
        for name, fn in (("jpeg", encode_jpeg), ("png", lambda f: write_png(io.BytesIO(), f))):
            t = time.perf_counter()
            for f in frames:
                fn(f)
            host[f"{name}_ms_per_page"] = (time.perf_counter() - t) / n * 1e3
        row["host_encoders"] = host

        # (d) the generator alone at full width
        dirty16 = np.stack(dirty * 4)
        flops = _gan_flops(overlay.config, h // overlay.gan_scale, w // overlay.gan_scale)
        ms, _ = _ms_per_call(lambda: overlay.segment_batch(list(dirty16), gate="off"))
        gan = {"pages": len(dirty16), "bf16_ms_per_page": ms / len(dirty16),
               "gflop_per_page": flops / 1e9,
               "bf16_tflops": flops * len(dirty16) / (ms * 1e-3) / 1e12}
        t = time.perf_counter()
        cpu = OverlayProcessor(device="cpu").segment_batch(dirty[:2], chunk=2,
                                                          compute_dtype="float32", gate="off")
        gan["cpu_check_s"] = time.perf_counter() - t
        card32 = overlay.segment_batch(dirty[:2], chunk=2, compute_dtype="float32", gate="off")
        diff = np.abs(np.stack(card32).astype(np.int16) - np.stack(cpu))
        gan["f32_card_cpu"] = {"equal": float(np.mean(diff == 0)), "max_diff": int(diff.max()),
                               "limit": GAN_CPU_EQUAL}
        d4 = torch.from_numpy(np.stack(dirty)).cuda()
        masks = {}
        for dt in ("float32", "bfloat16"):
            m, b = overlay._forward(_segment_batch_gray, dt, d4, overlay.gan_scale)
            masks[dt] = (m.cpu().numpy(), b.cpu().numpy())
        gan["golden_limits"] = {"pixels": GAN_COUNT_LIMIT, "sum": GAN_SUM_LIMIT}
        for dt, key in (("float32", "f32_against_golden"), ("bfloat16", "bf16_against_golden")):
            gan[key] = _off_golden(*masks[dt], dirty, golden["overlay"])
        (m32, b32), (m16, b16) = masks["float32"], masks["bfloat16"]
        d16 = np.abs(b16.astype(np.int16) - b32)
        gan["bf16_vs_f32"] = {"mask_equal": float(np.mean(m16 == m32)),
                              "equal": float(np.mean(d16 == 0)),
                              "within_1": float(np.mean(d16 <= 1)),
                              "within_4": float(np.mean(d16 <= 4)),
                              "limits": {"mask_equal": GAN_BF16_MASK_EQUAL,
                                         "within_4": GAN_BF16_WITHIN_4}}
        row["generator"] = gan
    emit(row)
    bf = gan["bf16_vs_f32"]
    if not (gan["f32_card_cpu"]["equal"] >= GAN_CPU_EQUAL
            and gan["f32_against_golden"]["within_limits"]
            and bf["mask_equal"] >= GAN_BF16_MASK_EQUAL and bf["within_4"] >= GAN_BF16_WITHIN_4):
        raise AssertionError(f"generator: {gan}")
    # the traced pass takes the last 8 pages (4 clean, the 4 dirty): the
    # profiler spends ~1.4 s a page on the job's ~530 launches a page
    return launches, {
        "extract_full": (_full_pipeline_pass(engine, overlay), frames[8:]),
        "overlay": (_Calls(lambda p: overlay.segment_batch(list(p), gate="off")), dirty)}


#: the ``register`` phase's limits against golden_register.json and the CPU
REGISTER_SCORE_LIMIT = 1e-4  # deskew scores: float32 variances summed in another order
REGISTER_SUM_LIMIT = 1e-6  # relative: input and deskewed page sums
CORNER_LIMIT = 1e-4  # the regressor's normalised corners
SCAN_SUM_LIMIT = 1e-5  # relative: the scans (host float32 solve, 255/254 flips)
MODEL_SUM_LIMIT = 1e-3  # relative: the model path's warped pages
MATCH_SCORE_LIMIT = 1e-3
#: the card's departures from the golden's matches in (c), as measured on
#: an NVIDIA H100 80GB HBM3 (700 W), and no more: DIM puts the noise
#: template on other windows of the pages' white bottom strip (15 pairs),
#: VQNNF drops its 16 noise rows scored at its threshold
MATCH_SWAPS = {"dim": 15, "composite": 15}
#: the templates whose rows may swap: the noise patch, found on no page,
#: whose every match is a blank window (the word crops' rows are exact)
TIE_LABELS = ("noise",)
MATCH_FLIPS = {"vqnnf": 16}
#: (d)'s golden-only NCC rows: JAX's float32 scores on windows whose
#: variance float32 cannot resolve (``_ncc_unresolved``; 6 measured on
#: the CPU, on page 9)
NCC_UNRESOLVED = 6
#: the model path's warp on the card against the CPU: the network's
#: float32 corners differ by ~1e-7, the small seeded quad magnifies, and
#: white paper flips 255/254 (at least WARP_EQUAL equal) and the quad's
#: edge between page and background (at most WARP_FAR beyond 1 level)
WARP_EQUAL = 0.95
WARP_FAR = 0.01
#: each matcher's threshold: its default; the composite passes its own
MATCH_THRESHOLDS = {"ncc": 0.8, "dim": 0.6, "vqnnf": 0.5, "composite": 0.8}
#: pages the CPU path repeats for the card-vs-CPU checks of (a) and (b)
REGISTER_CPU_PAGES = 2
REGISTER_PASSES = ("pass_1", "pass_2")
#: dirty pages of (d)'s pass with the cleaner on
CLEANER_PAGES = 2


def _rel(a, b) -> float:
    return abs(a - b) / max(abs(b), 1)


def _boundary_off(got, want) -> list:
    """Where a prediction dict differs from the golden's: detected, box
    and angle must be equal, the score within REGISTER_SCORE_LIMIT."""
    return [k for k in ("detected", "box", "angle") if got[k] != want[k]] + (
        ["score"] if abs(got["score"] - want["score"]) > REGISTER_SCORE_LIMIT else [])


def _uniform_strip(page, a, b) -> bool:
    """Whether boxes ``a`` and ``b`` ([x, y, w, h]) share their rows and
    every pixel from the one to the other is the same: windows no matcher
    can tell apart by their own pixels."""
    import numpy as np

    if a[1] != b[1] or a[3] != b[3]:
        return False
    x0, x1 = min(a[0], b[0]), max(a[0] + a[2], b[0] + b[2])
    strip = np.asarray(page)[a[1]:a[1] + a[3], x0:x1]
    return strip.size > 0 and strip.min() == strip.max()


def _gray64(img):
    """A page or template as float64 gray, the NCC matcher's preparation:
    the channel mean, then / 255 when it holds 0..255 values."""
    import numpy as np

    g = np.asarray(img, np.float64)
    if g.ndim == 3:
        g = g.mean(axis=-1)
    return g / 255.0 if g.max() > 1.5 else g


def _ncc_unresolved(page, template, box, threshold: float) -> bool:
    """Whether an NCC match at ``box`` is one that float32 cannot resolve:
    the window's NCC, taken in float64 on the host, is under ``threshold``
    and its variance sum((x - mean)^2) is under n * eps32 * sum(x^2), the
    rounding bound of the float32 box sums that the JAX matcher subtracts
    (the port takes them in float64)."""
    import numpy as np

    x, y, w, h = box
    win = _gray64(page)[y:y + h, x:x + w]
    t = _gray64(template)
    t = t - t.mean()
    var = float(((win - win.mean()) ** 2).sum())
    ncc = float((win * t).sum() / (np.sqrt(max(var, 1e-6)) * np.sqrt((t * t).sum() + 1e-6)))
    return ncc < threshold and var < win.size * np.finfo(np.float32).eps * float((win * win).sum())


def _matches_off(got, want, threshold: float, pages, swaps_limit: int = 0,
                 flips_limit: int = 0, unresolved=None, unresolved_limit: int = 0,
                 limit=MATCH_SCORE_LIMIT) -> dict:
    """Match rows [frame, label, bbox, score] against the golden's: the
    (frame, label, bbox) on one side only and the largest score gap of
    the common ones.  A row on one side only is explained only as

    * a tie swap: a card-only and a golden-only row (paired one to one)
      of the same frame and a label of TIE_LABELS, scores within
      ``limit``, whose boxes lie in one uniform strip of the page
      (``_uniform_strip``);
    * a threshold flip: its score within ``limit`` of ``threshold``;
    * an unresolved window: a golden-only row for which
      ``unresolved(frame, label, bbox)`` holds;

    each at most its ``*_limit`` times; any other row fails."""
    g = {(f, lbl, tuple(b)): sc for f, lbl, b, sc in got}
    w = {(f, lbl, tuple(b)): sc for f, lbl, b, sc in want}
    only = {"card": sorted(set(g) - set(w)), "golden": sorted(set(w) - set(g))}
    common = sorted(set(g) & set(w))
    err = max([abs(g[k] - w[k]) for k in common] or [0.0])
    paired, swaps = set(), 0
    for c in only["card"]:
        for k in only["golden"]:
            if (k not in paired and k[:2] == c[:2] and c[1] in TIE_LABELS
                    and abs(w[k] - g[c]) <= limit
                    and _uniform_strip(pages[c[0]], c[2], k[2])):
                paired.update((c, k))
                swaps += 1
                break
    flips, unres, unexplained = 0, 0, []
    for side, mine in (("card", g), ("golden", w)):
        for key in only[side]:
            if key in paired:
                continue
            if abs(mine[key] - threshold) <= limit:
                flips += 1
            elif side == "golden" and unresolved is not None and unresolved(*key):
                unres += 1
            else:
                unexplained.append([side, *key, mine[key]])
    return {"matches": len(got), "golden": len(want), "max_score_err": err,
            "tie_swaps": swaps, "threshold_flips": flips, "unresolved": unres,
            "limits": {"tie_swaps": swaps_limit, "threshold_flips": flips_limit,
                       "unresolved": unresolved_limit},
            "unexplained": unexplained,
            "within_limits": (not unexplained and err <= limit and swaps <= swaps_limit
                              and flips <= flips_limit and unres <= unresolved_limit)}


def _pixels(card, cpu) -> dict:
    import numpy as np

    d = np.abs(np.asarray(card).astype(np.int16) - np.asarray(cpu))
    return {"equal": float(np.mean(d == 0)), "far": float(np.mean(d > 1)),
            "max_diff": int(d.max())}


def phase_register(shipped):
    """The extract job's boundary-registration and template-matching
    stages on the card, against ``torch_zoo/golden_register.json`` (the
    JAX package on the same inputs, made here with the port from the
    shipped pages and ``REGISTER_SEED``):

    * (a) the weight-free deskew (``DocumentBoundaryRegistration(
      use_model=False)``) on the 16 pages, each rotated by a known angle
      in [-5, 5] degrees on the card (``skewed_pages``; their sums first
      checked against the golden's inputs): the golden's angle (the same
      grid index), box, score within REGISTER_SCORE_LIMIT and the
      registered page's sum within REGISTER_SUM_LIMIT; the registration's
      peak memory, here and on the 3300x2550 page; card against the CPU
      path on REGISTER_CPU_PAGES pages;
    * (b) the model path at full width, ``BoundaryConfig()`` drawn from
      the registration's seed, on 4 scanner canvases made on the card
      (``scans``): the network's normalised corners within CORNER_LIMIT,
      with the edge snap on the same snap and corners, box and angle
      equal, the warped page's sum within MODEL_SUM_LIMIT; card against
      CPU on REGISTER_CPU_PAGES scans (WARP_EQUAL, WARP_FAR);
    * (c) NCC, DIM and VQNNF (``CraftConfig.base()`` from the trunk's
      seed) and their composite on the 16 pages with the 4 word crops and
      the noise template of ``register_templates``: (frame, label, bbox)
      as the golden's, scores within MATCH_SCORE_LIMIT, but for the
      measured tie swaps in uniform strips and threshold flips
      (``_matches_off``, MATCH_SWAPS, MATCH_FLIPS); ms per page each;
    * (d) bench's ``full_pipeline`` job (``DefaultOcrEngine`` on the trained
      trees in bench's serving configuration, no heads) on the 16 pages
      with pages 12-15 made dirty, with ``page_boundary`` on (the deskew
      registration) and the composite of NCC, DIM and VQNNF, twice in one
      work dir, the cleaner off: ``metadata["boundary"]`` and
      ``["template_matching"]`` against the golden (the golden-only rows
      JAX's float32 NCC scores on windows it cannot resolve,
      ``_ncc_unresolved``, at most NCC_UNRESOLVED), the OCR of the
      registered pages against the JAX engine's on them
      (``check.py::agreement``, TEXT_AGREEMENT), stage seconds, ms/page,
      and K1 and K2 launches on ``"fused"``; then once on CLEANER_PAGES
      dirty pages with the cleaner on (the seeded generator, whose output
      is noise, on the registered RGB pages one by one): the clean pages
      against the CPU path's (GAN_CPU_EQUAL).

    Returns the launches of (d)'s passes and ``phase_profile``'s setup for
    one more pass on 4 pages."""
    import tempfile

    import numpy as np
    import torch

    from marie_tpu_torch.check import agreement
    from marie_tpu_torch.components.document_registration import (
        DocumentBoundaryRegistration,
    )
    from marie_tpu_torch.components.document_registration.boundary import refine_quad_corners
    from marie_tpu_torch.components.template_matching import (
        CompositeTemplateMatcher,
        DIMTemplateMatcher,
        NCCTemplateMatcher,
        VQNNFTemplateMatcher,
    )
    from marie_tpu_torch.models.configs import BoundaryConfig, CraftConfig
    from marie_tpu_torch.ocr.default_ocr_engine import DefaultOcrEngine
    from marie_tpu_torch.ocr.util import craft_box_processor, trocr_processor
    from marie_tpu_torch.overlay.overlay import OverlayProcessor
    from marie_tpu_torch.pipe import ExtractPipeline
    from marie_tpu_torch.registry.zoo import open_zoo_json
    from marie_tpu_torch.utils.image_io import read_png

    with open_zoo_json("golden_register") as f:
        golden = json.load(f)
    pages = list(shipped["pages"])
    n, (h, w) = len(pages), pages[0].shape
    row = {"phase": "register", "pages": n, "page_hw": [h, w]}
    fails = []

    # (a) the deskew path
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    skewed = skewed_pages(pages, "cuda")
    input_off = max(_rel(int(p.astype(np.int64).sum()), g["input_sum"])
                    for p, g in zip(skewed, golden["deskew"]))
    reg = DocumentBoundaryRegistration(use_model=False, device="cuda")
    reg.register(skewed[0])  # warm-up
    torch.cuda.synchronize()
    t = time.perf_counter()
    preds = [reg.register(p) for p in skewed]
    ms = (time.perf_counter() - t) / n * 1e3
    off = {i: _boundary_off(p.to_dict(), g) for i, (p, g) in enumerate(zip(preds, golden["deskew"]))}
    sums = max(_rel(int(p.aligned.astype(np.int64).sum()), g["aligned_sum"])
               for p, g in zip(preds, golden["deskew"]))
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    # the registration's memory on a US letter page at 300 dpi
    big = np.stack([shipped["oversize"]] * 3, axis=-1)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    big_pred = reg.register(big)
    oversize = {"page_hw": list(big.shape[:2]), "angle": big_pred.angle,
                "ms": (time.perf_counter() - t) * 1e3,
                "peak_mib": (torch.cuda.max_memory_allocated() - base) / 2**20}
    cpu = DocumentBoundaryRegistration(use_model=False, device="cpu")
    cpu_preds = [cpu.register(p) for p in skewed[:REGISTER_CPU_PAGES]]
    row["deskew"] = {
        "ms_per_page": ms, "input_sum_off": input_off, "aligned_sum_off": sums,
        "off_golden": {i: o for i, o in off.items() if o},
        "angles": [p.angle for p in preds], "peak_mib": peak, "oversize": oversize,
        "card_cpu": [{"off": _boundary_off(c.to_dict(), g.to_dict()), **_pixels(c.aligned,
                                                                                 g.aligned)}
                     for c, g in zip(preds, cpu_preds)]}
    if input_off > REGISTER_SUM_LIMIT or any(off.values()) or sums > REGISTER_SUM_LIMIT or any(
            r["off"] or r["equal"] < 1.0 for r in row["deskew"]["card_cpu"]):
        fails.append("deskew")

    # (b) the model path at full width
    made = scans(pages, "cuda")
    scan_off = max(_rel(int(sc.astype(np.int64).sum()), g["scan_sum"])
                   for (sc, _), g in zip(made, golden["model"]["edge_refine"]))
    model = {"scan_sum_off": scan_off}
    for key, refine in (("edge_refine", True), ("no_refine", False)):
        reg = DocumentBoundaryRegistration(edge_refine=refine, device="cuda")
        if reg.trained or reg.model_config != BoundaryConfig():
            raise AssertionError(f"the regressor is not the seeded BoundaryConfig(): {reg.trained}")
        reg.register(made[0][0])  # warm-up
        torch.cuda.synchronize()
        t = time.perf_counter()
        preds = [reg.register(sc) for sc, _ in made]
        part = {"ms_per_page": (time.perf_counter() - t) / len(made) * 1e3}
        corner_err, refined_equal, corners_err, sums, box_off = 0.0, True, 0.0, 0.0, {}
        for i, ((sc, _), p, g) in enumerate(zip(made, preds, golden["model"][key])):
            corners = reg.corners(sc)
            norm = corners / np.asarray([w - 1.0, h - 1.0], np.float32)
            corner_err = max(corner_err, float(np.abs(norm.reshape(-1) - g["pred"]).max()))
            snapped = refine_quad_corners(sc, corners) if refine else corners
            refined_equal &= bool(np.any(snapped != corners)) == g["refined"]
            corners_err = max(corners_err, float(np.abs(snapped - np.asarray(g["corners"])).max()))
            o = _boundary_off(p.to_dict(), g)
            if o:
                box_off[i] = o
            sums = max(sums, _rel(int(p.aligned.astype(np.int64).sum()), g["aligned_sum"]))
        part.update({"corner_err": corner_err, "refined_equal": refined_equal,
                     "corners_px_err": corners_err, "off_golden": box_off,
                     "aligned_sum_off": sums, "refined": [g["refined"] for g in golden["model"][key]]})
        cpu = DocumentBoundaryRegistration(edge_refine=refine, device="cpu")
        part["card_cpu"] = [
            {"off": _boundary_off(cp.to_dict(), p.to_dict()), **_pixels(p.aligned, cp.aligned)}
            for p, cp in zip(preds, (cpu.register(sc) for sc, _ in made[:REGISTER_CPU_PAGES]))]
        model[key] = part
        if (corner_err > CORNER_LIMIT or not refined_equal
                or corners_err > CORNER_LIMIT * max(h, w) or box_off or sums > MODEL_SUM_LIMIT
                or any(r["off"] or r["equal"] < WARP_EQUAL or r["far"] > WARP_FAR
                       for r in part["card_cpu"])):
            fails.append(f"model {key}")
    row["model"] = model
    if scan_off > SCAN_SUM_LIMIT:
        fails.append("scans")

    # (c) the matchers on the 16 pages
    templates = register_templates(shipped)
    ncc = NCCTemplateMatcher(device="cuda")
    dim = DIMTemplateMatcher(device="cuda")
    vq = VQNNFTemplateMatcher(device="cuda")
    if dim.trained or dim.config != CraftConfig.base():
        raise AssertionError("the trunk is not the seeded CraftConfig.base()")
    composite = CompositeTemplateMatcher([ncc, dim, vq])
    for label, img in templates:
        composite.add_template(label, img)
    matching = {}
    for name, m in (("ncc", ncc), ("dim", dim), ("vqnnf", vq), ("composite", composite)):
        m.match(pages[:1])  # warm-up
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = match_rows(m.match(pages))
        torch.cuda.synchronize()
        matching[name] = {"ms_per_page": (time.perf_counter() - t) / n * 1e3,
                          **_matches_off(got, golden["matching"][name], MATCH_THRESHOLDS[name],
                                         pages, MATCH_SWAPS.get(name, 0),
                                         MATCH_FLIPS.get(name, 0))}
        if not matching[name]["within_limits"]:
            fails.append(f"matching {name}")
    row["matching"] = matching

    # (d) bench's full_pipeline job with both stages
    frames = list(pages)
    for i, d in zip(DIRTY_PAGES, dirty_pages([pages[i] for i in DIRTY_PAGES])):
        frames[i] = d
    engine = DefaultOcrEngine(
        box_processor=craft_box_processor(256, cc_runs=32, device="cuda"),
        ocr_processor=trocr_processor(device="cuda", batch_sizes=(32, 128, 256)),
        upload_format="u2", compact_slots=160, page_fuse_batch=16, device="cuda")
    conf = {"page_boundary": {"enabled": True}, "page_cleaner": {"enabled": False}}
    want_ocr = [{"words": [{"text": t, "box": b} for t, b in page]}
                for page in golden["pipeline"]["ocr"]]
    # the pages the job's registration gives, for the checks of its matches
    registered = [DocumentBoundaryRegistration(use_model=False, device="cuda").register(f).aligned
                  for f in frames]
    if [int(r.astype(np.int64).sum()) for r in registered] != golden["pipeline"]["aligned_sums"]:
        fails.append("job registered pages")
    images = dict(templates)
    ncc_golden = {(f, lbl, tuple(b)): sc for f, lbl, b, sc in golden["pipeline"]["ncc"]}
    want_tm = {(f, lbl, tuple(b)): sc for f, lbl, b, sc in golden["pipeline"]["composite"]}

    def unresolved(f, lbl, box):  # a golden row of JAX's NCC on an unresolved window
        return (ncc_golden.get((f, lbl, box)) == want_tm[(f, lbl, box)] and _ncc_unresolved(
            registered[f], images[lbl], box, MATCH_THRESHOLDS["composite"]))

    launches = {}
    with tempfile.TemporaryDirectory() as work_dir:
        pipe = ExtractPipeline(ocr_engine=engine, classifiers=[], indexers=[],
                               work_dir=work_dir, device="cuda",
                               boundary_processor=DocumentBoundaryRegistration(
                                   use_model=False, device="cuda"),
                               template_matcher=composite)
        for k, name in enumerate(REGISTER_PASSES):
            _reset_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            meta = pipe.execute(f"bench{k}", "bench_pdf", list(frames), job_id=name,
                                runtime_conf=conf)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            launches[name] = _read_counts()
            _check_results(meta["ocr"], n, h, w)
            boundary_off = {b["page"]: _boundary_off(b, g) for b, g in
                            zip(meta["boundary"], golden["pipeline"]["boundary"])}
            tm = _matches_off([[m["frame_index"], m["label"], m["bbox"], m["score"]]
                               for m in meta["template_matching"]],
                              golden["pipeline"]["composite"], MATCH_THRESHOLDS["composite"],
                              registered, unresolved=unresolved,
                              unresolved_limit=NCC_UNRESOLVED)
            ocr = agreement(want_ocr, meta["ocr"])
            p = {"wall_ms": wall * 1e3, "ms_per_page": wall / n * 1e3, "pages_per_s": n / wall,
                 "stage_times_s": meta["stage_times_s"], "launches": launches[name],
                 "boundary_off": {i: o for i, o in boundary_off.items() if o},
                 "template_matching": tm, "ocr_agreement": ocr}
            row[f"job_{name}"] = p
            if (any(boundary_off.values()) or not tm["within_limits"]
                    or ocr["words"] < TEXT_AGREEMENT
                    or not {"boundary", "template_matching"} <= set(meta["stage_times_s"])
                    or not all(launches[name][k].get("fused", 0) > 0
                               for k in ("crop_resize", "flash_attention"))):
                fails.append(f"job {name}")

    # the job as a user gets it with the stage on and the cleaner at its
    # default (on), on 2 dirty pages: the registered RGB pages go one by one
    # through the seeded generator in float32; its clean/ pages against the
    # CPU path's (the registration and the generator on the CPU)
    some = frames[DIRTY_PAGES[0]:DIRTY_PAGES[0] + CLEANER_PAGES]
    overlay = OverlayProcessor(device="cuda")
    with tempfile.TemporaryDirectory() as work_dir:
        meta = ExtractPipeline(ocr_engine=engine, classifiers=[], indexers=[],
                               overlay_processor=overlay, work_dir=work_dir, device="cuda",
                               boundary_processor=DocumentBoundaryRegistration(
                                   use_model=False, device="cuda"),
                               template_matcher=composite).execute(
            "clean0", "bench_pdf", list(some), runtime_conf={"page_boundary": {"enabled": True}})
        (root,) = [os.path.join(work_dir, d) for d in os.listdir(work_dir)]
        clean = [read_png(os.path.join(root, "clean", name))
                 for name in sorted(os.listdir(os.path.join(root, "clean")))]
    _check_results(meta["ocr"], CLEANER_PAGES, h, w)
    cpu_reg = DocumentBoundaryRegistration(use_model=False, device="cpu")
    cpu_clean = OverlayProcessor(device="cpu").segment_batch(
        [cpu_reg.register(f).aligned for f in some])
    row["job_cleaner_on"] = {
        "pages": CLEANER_PAGES, "generator_calls": overlay.calls,
        "stage_times_s": meta["stage_times_s"], "matches": len(meta["template_matching"]),
        "card_cpu": _pixels(np.stack(clean), np.stack(cpu_clean)), "limit": GAN_CPU_EQUAL}
    if (overlay.calls != CLEANER_PAGES
            or row["job_cleaner_on"]["card_cpu"]["equal"] < GAN_CPU_EQUAL):
        fails.append("job cleaner on")
    emit(row)
    if fails:
        raise AssertionError(f"register: {fails}")

    def job(pages4):
        with tempfile.TemporaryDirectory() as work_dir:
            return ExtractPipeline(ocr_engine=engine, classifiers=[], indexers=[],
                                   work_dir=work_dir, device="cuda",
                                   boundary_processor=DocumentBoundaryRegistration(
                                       use_model=False, device="cuda"),
                                   template_matcher=composite).execute(
                "bench0", "bench_pdf", list(pages4), runtime_conf=conf)

    return launches, {"extract_register": (_Calls(job), frames[:4])}


#: the ``detectors`` phase: seeds of the seeded detector trees (the
#: trained trees are not shipped), the shipped pages each part runs, the
#: block size of the heatmap means held against the golden
DETECTOR_SEEDS = {"dit_s1": SEED + 60, "dit_default": SEED + 61, "textfusenet": SEED + 62}
DIT_PAGES = (0, 5, 10, 15)
DIT_DEFAULT_PAGES = (0, 5)
TFN_PAGES = (0, 5, 10, 15)
DETECTOR_CPU_PAGES = 2
HEAT_BLOCK = 16
CC_TIMED_CALLS = 5  # calls of each CC stats variant on the 16 pages, timed together


def block_means(heat, block: int = HEAT_BLOCK):
    """[h, w] or [h, w, c] map -> the means of its block x block tiles,
    float64 rounded to 6 decimals (what the golden keeps of a heatmap)."""
    import numpy as np

    a = np.asarray(heat, np.float64)
    if a.ndim == 2:
        a = a[..., None]
    h, w, c = a.shape
    m = a.reshape(h // block, block, w // block, block, c).mean(axis=(1, 3))
    return np.round(m, 6)


def detector_thresholds(maps, quantiles):
    """Thresholds at the given quantiles of the pooled maps (the golden's
    rule where a seeded model's map gives no box at the defaults)."""
    import numpy as np

    pooled = np.concatenate([np.asarray(m, np.float32).ravel() for m in maps])
    return [float(np.quantile(pooled, q)) for q in quantiles]


#: card against golden: heatmap block means (float32 through 6 layers or
#: the FPN, TF32 kept out; the attention's 3xTF32 within 1e-5)
DETECTOR_BLOCK_LIMIT = 1e-4
#: card against the port's CPU: TextFuseNet's fused scores and refined
#: boxes (stride-4 cells) on valid slots both sides share
TFN_FUSE_LIMIT = 1e-3
#: the port's CPU against JAX on the heatmaps (tests/test_torch_detectors.py;
#: measured 3.6e-7 on DiT-s1's, 1.8e-7 on TextFuseNet's word and char maps)
CPU_HEAT_LIMIT = 2e-6
#: card against the port's CPU: the largest map difference each detector
#: may show (float32 with TF32 kept out, the attention's 3xTF32).  Measured
#: on an H100 (PERF.md): 4.8e-6 (dit_s1), 1.5e-5 (dit_default), 2.4e-7
#: (TextFuseNet's word and char maps); each limit is about four times it
CARD_CPU_GAP_LIMIT = {"dit_s1": 2e-5, "dit_default": 6e-5, "textfusenet": 1e-6}
#: boxes of one page that may depart from a reference's, each through a map
#: pixel that crossed, or can cross, a threshold: one such pixel gains or
#: loses a part (1 box on one side only), grows or cuts a box (2), merges
#: or splits two (3).  Measured against the golden: 1 on 2 of DiT-s1's 4
#: pages, none elsewhere
DEPARTURE_CAP = 3


def _xyxy(xywh):
    import numpy as np

    b = np.asarray(xywh, np.float64).reshape(-1, 4)
    return np.concatenate([b[:, :2], b[:, :2] + b[:, 2:]], axis=1)


def _pair_boxes(got, want, close):
    """Pairs (i, j) of [N, 4] and [M, 4] boxes whose coordinates differ
    by at most ``close``, each box in one pair at most (the first free
    match, in order)."""
    import numpy as np

    if not len(got) or not len(want):
        return []
    near = np.abs(got[:, None, :] - want[None, :, :]).max(axis=-1) <= close
    pairs, used = [], np.zeros(len(want), bool)
    for i in range(len(got)):
        free = np.flatnonzero(near[i] & ~used)
        if len(free):
            used[free[0]] = True
            pairs.append((i, int(free[0])))
    return pairs


def _lone(got, want, pairs):
    """The boxes of either side in no pair."""
    gi, wj = {i for i, _ in pairs}, {j for _, j in pairs}
    return ([b for i, b in enumerate(got) if i not in gi]
            + [b for j, b in enumerate(want) if j not in wj])


def _covers(box, pixels, to_map) -> bool:
    """Whether an xyxy box, scaled by ``to_map`` into the map and grown by
    one pixel, covers a pixel of the bool map ``pixels``."""
    import numpy as np

    h, w = pixels.shape
    x0, y0 = (max(int(np.floor(v * to_map)) - 1, 0) for v in box[:2])
    x1 = min(int(np.ceil(box[2] * to_map)) + 1, w)
    y1 = min(int(np.ceil(box[3] * to_map)) + 1, h)
    return bool(pixels[y0:y1, x0:x1].any())


def threshold_pixels(card, thresholds, ref=None, tol=0.0):
    """The map pixels through which a box may depart from a reference's:
    with the reference's map ``ref``, those on the other side of a
    threshold than it; without (a reference known to within ``tol``),
    those within ``tol`` of a threshold."""
    import numpy as np

    card = np.asarray(card, np.float32)
    out = np.zeros(card.shape, bool)
    for t in thresholds:
        if ref is None:
            out |= np.abs(card.astype(np.float64) - t) <= tol
        else:
            out |= (card > np.float32(t)) != (np.asarray(ref, np.float32) > np.float32(t))
    return out


def _paired_boxes(got, want, close):
    """Boxes (xywh, scores) of one page against a reference's: (the boxes
    of either side in no pair, xyxy; the largest score difference of a
    pair)."""
    import numpy as np

    gb, wb = _xyxy(got[0]), _xyxy(want[0])
    gs, ws = np.asarray(got[1], np.float64), np.asarray(want[1], np.float64)
    pairs = _pair_boxes(gb, wb, close)
    return _lone(gb, wb, pairs), float(max((abs(gs[i] - ws[j]) for i, j in pairs),
                                           default=0.0))


def detector_page_rule(got, want, pixels, to_map, tol):
    """One page of detector boxes (xywh page coordinates, scores) against a
    reference's (the port's CPU or the JAX golden): boxes paired where
    equal; every box on one side only covers a pixel of ``pixels``
    (:func:`threshold_pixels`; page to map by ``to_map``), at most
    DEPARTURE_CAP of them; paired scores within ``tol``.  A row with
    ``within_limits``."""
    lone, score_err = _paired_boxes(got, want, 0.0)
    unexplained = sum(not _covers(b, pixels, to_map) for b in lone)
    return {"boxes": len(got[0]), "ref_boxes": len(want[0]), "departures": len(lone),
            "unexplained": unexplained, "threshold_pixels": int(pixels.sum()),
            "score_err": score_err,
            "within_limits": unexplained == 0 and len(lone) <= DEPARTURE_CAP
            and score_err <= tol}


def tfn_page_rule(got, want, word_pixels, char_pixels, to_map, limit):
    """TextFuseNet's valid word slots of one page (``heat_boxes``, fused
    ``scores``, ``refined`` boxes) against a reference's, paired by heat
    box: a slot on one side only covers a pixel of ``word_pixels``; a
    paired slot's score and refined box lie within ``limit``, or its heat
    box covers a pixel of ``char_pixels`` (a char candidate that may have
    changed); at most DEPARTURE_CAP of both.  A row with ``within_limits``
    and ``word_departures``, the ``detect_words`` boxes these may move
    (one per lone slot, two per changed one)."""
    import numpy as np

    gh, wh = (np.asarray(x["heat_boxes"], np.float64).reshape(-1, 4) for x in (got, want))
    pairs = _pair_boxes(gh, wh, 0.0)
    lone = _lone(gh, wh, pairs)
    unexplained = sum(not _covers(b, word_pixels, to_map) for b in lone)
    changed, fuse_err = 0, 0.0
    for i, j in pairs:
        err = max(abs(float(got["scores"][i]) - float(want["scores"][j])), float(np.abs(
            np.asarray(got["refined"][i]) - np.asarray(want["refined"][j])).max()))
        if err <= limit:
            fuse_err = max(fuse_err, err)
        else:
            changed += 1
            unexplained += not _covers(gh[i], char_pixels, to_map)
    return {"slots": len(gh), "ref_slots": len(wh), "lone_slots": len(lone),
            "changed_slots": changed, "unexplained": unexplained, "fuse_err": fuse_err,
            "word_departures": len(lone) + 2 * changed,
            "within_limits": unexplained == 0 and len(lone) + changed <= DEPARTURE_CAP}


def tfn_words_rule(got, want, allowed, limit):
    """TextFuseNet's ``detect_words`` boxes (xywh, scores) against a
    reference's: paired within 4 x ``limit`` (refined boxes are stride-4
    cells), at most ``allowed`` boxes on one side only
    (:func:`tfn_page_rule`'s ``word_departures``), paired scores within
    ``limit``.  A row with ``within_limits``."""
    lone, score_err = _paired_boxes(got, want, 4 * limit)
    return {"boxes": len(got[0]), "ref_boxes": len(want[0]), "departures": len(lone),
            "allowed": allowed, "score_err": score_err,
            "within_limits": len(lone) <= allowed and score_err <= limit}


def dit_golden_rule(name, found, heats, g, to_map):
    """The DiT part's hold on the golden: on each page, the card's boxes
    against the golden's by :func:`detector_page_rule`, through the
    card's map pixels within the card-to-JAX tolerance of a threshold.
    Returns (within the rule, rows)."""
    tol = CARD_CPU_GAP_LIMIT[name] + CPU_HEAT_LIMIT
    thresholds = [g["low_text"], g["text_threshold"]]
    rows = [{"page": gp["page"], **detector_page_rule(
        found[k], (gp["boxes"], gp["scores"]),
        threshold_pixels(heats[k][..., 0], thresholds, tol=tol), to_map, tol)}
        for k, gp in enumerate(g["pages"])]
    return all(r["within_limits"] for r in rows), rows


def tfn_golden_rule(found, card, g, to_map):
    """TextFuseNet's hold on the golden: on each page, the card's valid
    slots by :func:`tfn_page_rule` and its ``detect_words`` boxes by
    :func:`tfn_words_rule`, through the card's map pixels within the
    card-to-JAX tolerance of a threshold.  ``card``: per page (word and
    char maps, the valid slots' stats).  Returns (within the rule, rows)."""
    import numpy as np

    tol = CARD_CPU_GAP_LIMIT["textfusenet"] + CPU_HEAT_LIMIT
    rows = []
    for k, gp in enumerate(g["pages"]):
        maps, slots = card[k]
        word_px = threshold_pixels(maps["word"][..., 0], [g["low_text"], g["word_threshold"]],
                                   tol=tol)
        char_px = threshold_pixels(maps["char"][..., 0], [g["char_threshold"]], tol=tol)
        want = {"heat_boxes": gp["heat_boxes"], "scores": gp["fused_scores"],
                "refined": np.asarray(gp["refined"], np.float64).reshape(-1, 4)}
        slot_row = tfn_page_rule(slots, want, word_px, char_px, to_map, TFN_FUSE_LIMIT)
        words = tfn_words_rule(found[k], (gp["boxes"], gp["scores"]),
                               slot_row["word_departures"], TFN_FUSE_LIMIT)
        rows.append({"page": gp["page"], "slots": slot_row, "words": words,
                     "within_limits": slot_row["within_limits"] and words["within_limits"]})
    return all(r["within_limits"] for r in rows), rows


def _valid_slots(st):
    """TextFuseNet's stats on their valid word slots, as
    :func:`tfn_page_rule` takes them."""
    v = st["valid"]
    return {"heat_boxes": st["heat_boxes"][v], "scores": st["scores"][v],
            "refined": st["boxes"][v]}


def _words_compare(card, cpu, allowed):
    """Engine results, card against CPU, page by page: a card word at IoU
    >= BOX_IOU_LIMIT for a CPU word, boxes moved plus words on one side
    only at most ``allowed[page]`` (the detector's boxes that departed
    there, card against CPU), texts equal wherever boxes are.  Returns
    (within the rule, boxes moved, words on one side only, words whose
    equal boxes carry different texts)."""
    from marie_tpu_torch.check import match_words

    ok, moved, one_sided, text_off = True, 0, 0, 0
    for p, (a, b) in enumerate(zip(card, cpu)):
        pairs = match_words(b["words"], a["words"], BOX_IOU_LIMIT - 1e-9)
        lone = len(a["words"]) + len(b["words"]) - 2 * len(pairs)
        page_moved = sum(a["words"][ai]["box"] != b["words"][bi]["box"] for bi, ai in pairs)
        one_sided += lone
        moved += page_moved
        text_off += sum(a["words"][ai]["text"] != b["words"][bi]["text"] for bi, ai in pairs
                        if a["words"][ai]["box"] == b["words"][bi]["box"])
        ok &= lone + page_moved <= allowed[p]
    return ok and text_off == 0, moved, one_sided, text_off


def _float32_recognizers():
    """The trained TrOCR in float32 on the card and on the CPU: the
    detectors' engine checks compare their paths, not bf16 near-ties of
    the recogniser on the noise crops of seeded detectors."""
    from marie_tpu_torch.document.trocr_ocr_processor import TrOcrProcessor
    from marie_tpu_torch.models.configs import TrOCRConfig
    from marie_tpu_torch.ocr.util import RECOGNIZER_TREE
    from marie_tpu_torch.registry.zoo import zoo_params

    params = zoo_params(RECOGNIZER_TREE)
    if params is None:
        raise AssertionError(f"torch_zoo/ lacks {RECOGNIZER_TREE}")
    return {dev: TrOcrProcessor(config=TrOCRConfig.fast_v3_g2_d6(), params=params,
                                param_dtype="float32", batch_sizes=(32, 128, 256), device=dev)
            for dev in ("cuda", "cpu")}


def _timed_pages(fn, items):
    """(outputs, wall ms per item) of ``fn`` on each item, synchronised."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = [fn(x) for x in items]
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3 / len(items)


def phase_detectors(shipped, trained_engine):
    """The other word detectors on the card, each against the JAX golden
    (``golden_detectors.json``) and the port's CPU path, and the CC stats
    variants:

    (a) ``PipelineOcrEngine(InkBoxProcessor(), trained TrOCR)`` on the 16
    pages, twice (the page-resident path: RGB device pages, crops by stock
    ops, so no K1): boxes equal the golden's, text agreement and CER
    within the ``trained`` limits, card equal to the CPU on 2 pages
    (scores within ``BF16_SCORE_LIMIT``); recall, precision, IoU and CER
    against the truth are reported.
    (b) The DiT detector at ``dit_synth_s1`` width on 4 pages and at the
    no-tree configuration on 2 (seeded): heatmap block means within
    DETECTOR_BLOCK_LIMIT of the golden; the card's heatmaps within
    CARD_CPU_GAP_LIMIT of the CPU's; ``detect_words`` against the golden's
    on every page and the CPU's on the first (2 and 1) by
    :func:`detector_page_rule` (every departing box through a map pixel
    that can cross, or did cross, a threshold; at most DEPARTURE_CAP a
    page); K2 float32 6 times a page on ``"detectors"``; the engine over
    it (host fragments, the trained TrOCR in float32), card against CPU
    on the 2 pages of the CPU check: boxes at IoU >= 0.9, moved boxes and
    words on one side only at most the detector's departures of that page,
    texts equal where boxes are.
    (c) The trained serving engine under each ``cc_stats``: every
    variant's stats on the 16 pages equal ``runs_cc``'s, the engine's
    results equal, K1 and K2 launched on ``"fused"``; CC-and-stats ms a
    page of each.
    (d) TextFuseNet at ``synth_s2`` (seeded) on 4 pages: dense maps' block
    means against the golden, the word and char maps within
    CARD_CPU_GAP_LIMIT of the CPU's, the valid slots (fused scores,
    refined boxes) and ``detect_words`` against the golden and the CPU by
    :func:`tfn_page_rule` and :func:`tfn_words_rule`; the engine card
    against CPU on 2 pages, as (b)'s.

    Every part prints its mask pixels and boxes and fails on none.
    Returns (the launches of each part by path, {name: (card engine,
    pages)} for ``phase_profile``)."""
    import numpy as np
    import torch

    from marie_tpu_torch.boxes import (
        BoxProcessorTextFuseNet,
        BoxProcessorUlimDit,
        InkBoxProcessor,
    )
    from marie_tpu_torch.boxes.box_processor import fit_page
    from marie_tpu_torch.boxes.craft_box_processor import (
        CC_STATS,
        cc_component_stats,
        craft_heatmap,
        detect_core,
        heat_masks,
    )
    from marie_tpu_torch.boxes.dit_box_processor import DEFAULT_CONFIG, dit_heatmap
    from marie_tpu_torch.boxes.textfusenet_box_processor import tfn_detect
    from marie_tpu_torch.check import agreement
    from marie_tpu_torch.models.configs import TextFuseNetConfig, ViTConfig
    from marie_tpu_torch.ocr.ocr_engine import PipelineOcrEngine
    from marie_tpu_torch.ocr.util import trocr_processor
    from marie_tpu_torch.preprocess.ops import normalize_page
    from marie_tpu_torch.registry.convert import init_flax_layout
    from marie_tpu_torch.registry.zoo import open_zoo_json
    from marie_tpu_torch.utils.device import float32_precision

    with open_zoo_json("golden_detectors") as f:
        golden = json.load(f)
    pages = list(shipped["pages"])
    n, (h, w) = len(pages), pages[0].shape
    rgb = [np.stack([p] * 3, axis=-1) for p in pages]
    truth = shipped["truth"]["pages"]
    cpu_pages = pages[:DETECTOR_CPU_PAGES]
    ops = {dev: trocr_processor(device=dev, batch_sizes=(32, 128, 256))
           for dev in ("cuda", "cpu")}
    launches, failed = {}, []

    def check(part, ok, row):
        emit({"phase": "detectors", "part": part, "within_limits": bool(ok), **row})
        if not ok:
            failed.append(part)

    # (a) ink, the page-resident path
    engines = {dev: PipelineOcrEngine(InkBoxProcessor(device=dev), ops[dev])
               for dev in ("cuda", "cpu")}
    engines["cuda"].extract(pages)
    _reset_counts()
    results, ms = _timed_pages(lambda ps: engines["cuda"].extract(ps), [pages])
    results = results[0]
    launches["ink"] = _read_counts()
    gold = [{"words": [{"text": t, "box": b, "confidence": c} for t, b, c in page]}
            for page in golden["ink"]["pages"]]
    box_pages = [p for p, (a, g) in enumerate(zip(results, gold))
                 if [wd["box"] for wd in a["words"]] != [wd["box"] for wd in g["words"]]]
    row = _against_golden(results, gold, truth, (h, w))
    cpu = engines["cpu"].extract(cpu_pages)
    equal, score_err = _results_equal(results[:len(cpu)], cpu)
    words = sum(len(r["words"]) for r in results)
    check("ink", not box_pages and row["within_limits"] and equal
          and score_err <= BF16_SCORE_LIMIT and words > 0 and
          launches["ink"]["flash_attention"].get("two_phase", 0) > 0
          and launches["ink"]["crop_resize"]["all"] == 0,
          {"pages": n, "ms_per_page": ms / n, "words": words,
           "pages_with_other_boxes": box_pages, "card_equals_cpu": equal,
           "cpu_pages": len(cpu), "max_score_err": score_err, "launches": launches["ink"],
           **row})

    # (b) DiT at both widths
    def dit_part(name, config, ids, cpu_ids):
        g = golden[name]
        tree = init_flax_layout(config, DETECTOR_SEEDS[name])
        bps = {dev: BoxProcessorUlimDit(config=config, variables=tree, device=dev,
                                        low_text=g["low_text"],
                                        text_threshold=g["text_threshold"],
                                        min_area=g["min_area"])
               for dev in ("cuda", "cpu")}
        thresholds = [g["low_text"], g["text_threshold"]]
        imgs = [rgb[i] for i in ids]
        bps["cuda"].detect_words(imgs[0])
        _reset_counts()
        found, det_ms = _timed_pages(bps["cuda"].detect_words, imgs)
        counts = _read_counts()
        # page coordinates to heatmap pixels
        to_map = bps["cuda"].buckets.fit_with_scale(h, w)[1] / config.head_stride

        def heatmap(bpd, img):
            return dit_heatmap(bpd.model, fit_page(img, bpd.buckets, bpd.device)[0]).cpu().numpy()

        heats = [heatmap(bps["cuda"], im) for im in imgs]
        block_err = max(float(np.abs(block_means(hm) - np.asarray(gp["block_means"])).max())
                        for hm, gp in zip(heats, g["pages"]))
        cpu_heats = [heatmap(bps["cpu"], rgb[i]) for i in cpu_ids]
        gap = max(float(np.abs(heats[k] - c).max()) for k, c in enumerate(cpu_heats))
        limit = CARD_CPU_GAP_LIMIT[name]
        cpu_rows = [{"page": i, **detector_page_rule(
            found[k], bps["cpu"].detect_words(rgb[i]),
            threshold_pixels(heats[k][..., 0], thresholds, ref=cpu_heats[k][..., 0]),
            to_map, limit)} for k, i in enumerate(cpu_ids)]
        golden_ok, golden_rows = dit_golden_rule(name, found, heats, g, to_map)
        mask_px = [int((hm[..., 0] > g["low_text"]).sum()) for hm in heats]
        k2 = counts["flash_attention"].get("detectors", 0)
        ok = (block_err <= DETECTOR_BLOCK_LIMIT and gap <= limit
              and all(r["within_limits"] for r in cpu_rows) and golden_ok
              and min(mask_px) > 0 and sum(len(b) for b, _ in found) > 0
              and k2 == config.num_layers * len(ids))
        return bps, ok, {"config": name, "tokens": config.seq_len, "pages": list(ids),
                         "detector_ms_per_page": det_ms, "thresholds": g["thresholds"],
                         "low_text": g["low_text"], "text_threshold": g["text_threshold"],
                         "min_area": g["min_area"],
                         "block_err": block_err, "block_limit": DETECTOR_BLOCK_LIMIT,
                         "card_cpu_heat_gap": gap, "gap_limit": limit,
                         "departure_cap": DEPARTURE_CAP, "mask_pixels": mask_px,
                         "cpu": cpu_rows, "golden": golden_rows, "k2_detectors": k2,
                         "launches": counts}

    dit_ids = DIT_PAGES[:DETECTOR_CPU_PAGES]
    dit_bps, ok, row = dit_part("dit_s1", ViTConfig.dit_synth_s1(), DIT_PAGES, dit_ids)
    launches["dit_s1"] = row["launches"]
    recognizers = _float32_recognizers()
    dit_engines = {dev: PipelineOcrEngine(dit_bps[dev], recognizers[dev])
                   for dev in ("cuda", "cpu")}
    eng_pages = [pages[i] for i in dit_ids]
    dit_engines["cuda"].extract(eng_pages[:1])
    _reset_counts()
    card, eng_ms = _timed_pages(lambda ps: dit_engines["cuda"].extract(ps), [eng_pages])
    card = card[0]
    launches["dit_engine"] = _read_counts()
    cpu = dit_engines["cpu"].extract(eng_pages)
    same, moved, one_sided, text_off = _words_compare(
        card, cpu, [r["departures"] for r in row["cpu"]])
    eng_ok = (same and sum(len(r["words"]) for r in card) > 0
              and launches["dit_engine"]["flash_attention"].get("detectors", 0)
              == 6 * len(eng_pages)
              and launches["dit_engine"]["flash_attention"].get("fragments", 0) > 0)
    check("dit_s1", ok and eng_ok, {**row, "engine_ms_per_page": eng_ms / len(eng_pages),
                                    "engine_recognizer": "trained TrOCR, float32",
                                    "engine_words": sum(len(r["words"]) for r in card),
                                    "engine_within_rule": same, "engine_boxes_moved": moved,
                                    "engine_one_sided": one_sided,
                                    "engine_text_off": text_off,
                                    "engine_launches": launches["dit_engine"]})
    setups = {"detectors_dit_s1": (dit_engines["cuda"], eng_pages)}
    _, ok, row = dit_part("dit_default", DEFAULT_CONFIG, DIT_DEFAULT_PAGES,
                          DIT_DEFAULT_PAGES[:1])
    launches["dit_default"] = row["launches"]
    check("dit_default", ok, row)

    # (c) the CC stats variants on the trained serving engine
    bp = trained_engine.box_processor
    dev_pages = torch.from_numpy(np.stack(pages)).cuda()
    rgb_pages, heat = craft_heatmap(bp.model, dev_pages)
    mask, scores, _ = heat_masks(heat, rgb_pages, bp.low_text, bp.link_threshold,
                                 bp.model.cfg.out_stride, bp.box_source)
    ref = trained_engine.extract(pages)
    base = None
    variant_rows = {}
    for name in ["runs_cc"] + sorted(set(CC_STATS) - {"runs_cc"}):
        cc_component_stats(mask, scores, bp.max_components, name, bp.cc_runs)
        stats, cc_ms = _timed_pages(
            lambda _: cc_component_stats(mask, scores, bp.max_components, name, bp.cc_runs),
            range(CC_TIMED_CALLS))
        stats = {k: v.cpu() for k, v in stats[0].items()}
        core = detect_core(bp.model, dev_pages, bp.text_threshold, bp.low_text,
                           bp.link_threshold, bp.max_components, bp.box_source,
                           cc_stats=name, cc_runs=bp.cc_runs)
        if base is None:
            base = stats
        bp.cc_stats = name
        _reset_counts()
        try:
            got = trained_engine.extract(pages)
            torch.cuda.synchronize()
        finally:
            bp.cc_stats = "runs_cc"
        counts = _read_counts()
        launches[f"cc_{name}"] = counts
        stats_equal = all(torch.equal(stats[k], base[k]) for k in base) and all(
            torch.equal(core[k].cpu(), base[k]) for k in base)
        equal, score_err = _results_equal(got, ref)
        variant_rows[name] = {"cc_ms_per_page": cc_ms / n, "stats_equal": stats_equal,
                              "results_equal": equal, "max_score_err": score_err,
                              "valid": int(stats["valid"].sum()),
                              "k1_fused": counts["crop_resize"].get("fused", 0),
                              "k2_fused": counts["flash_attention"].get("fused", 0)}
    ok = all(r["stats_equal"] and r["results_equal"] and r["max_score_err"] == 0.0
             and r["k1_fused"] > 0 and r["k2_fused"] > 0 and r["valid"] > 0
             for r in variant_rows.values())
    check("cc_stats", ok, {"pages": n, "mask_pixels": int(mask.sum()),
                           "variants": variant_rows})
    del dev_pages, rgb_pages, heat, mask, scores

    # (d) TextFuseNet
    g = golden["textfusenet"]
    config = TextFuseNetConfig.synth_s2()
    tree = init_flax_layout(config, DETECTOR_SEEDS["textfusenet"])
    bps = {dev: BoxProcessorTextFuseNet(config=config, variables=tree, device=dev,
                                        low_text=g["low_text"],
                                        word_threshold=g["word_threshold"],
                                        char_threshold=g["char_threshold"],
                                        fuse_threshold=g["fuse_threshold"],
                                        min_area=g["min_area"])
           for dev in ("cuda", "cpu")}
    imgs = [rgb[i] for i in TFN_PAGES]
    bps["cuda"].detect_words(imgs[0])
    found, det_ms = _timed_pages(bps["cuda"].detect_words, imgs)

    def dense_and_stats(dev, img):
        bpd = bps[dev]
        page = fit_page(img, bpd.buckets, bpd.device)[0]
        with torch.no_grad(), float32_precision(False):
            dense = bpd.model.dense(normalize_page(page)[None])
        st = tfn_detect(bpd.model, page, bpd.word_threshold, bpd.low_text, bpd.char_threshold)
        return ({k: v[0].cpu().numpy() for k, v in dense.items() if k in ("word", "char")},
                {k: v.cpu().numpy() for k, v in st.items()})

    card = [dense_and_stats("cuda", im) for im in imgs]
    block_err = 0.0
    for (dense, st), gp in zip(card, g["pages"]):
        for key, got in (("word_means", dense["word"]), ("char_means", dense["char"]),
                         ("seg_means", st["seg"])):
            block_err = max(block_err, float(np.abs(block_means(got)
                                                    - np.asarray(gp[key])).max()))
    thresholds = {"word": [g["low_text"], g["word_threshold"]], "char": [g["char_threshold"]]}
    to_map = 4.0 / config.head_stride  # stride-4 cells to map pixels
    limit = CARD_CPU_GAP_LIMIT["textfusenet"]
    cpu_rows, gap = [], 0.0
    for k in range(DETECTOR_CPU_PAGES):
        dense_c, st_c = dense_and_stats("cpu", imgs[k])
        dense, st = card[k]
        gap = max(gap, *(float(np.abs(dense[m] - dense_c[m]).max()) for m in ("word", "char")))
        word_px, char_px = (threshold_pixels(dense[m][..., 0], thresholds[m],
                                             ref=dense_c[m][..., 0]) for m in ("word", "char"))
        slots = tfn_page_rule(_valid_slots(st), _valid_slots(st_c), word_px, char_px, to_map,
                              TFN_FUSE_LIMIT)
        words = tfn_words_rule(found[k], bps["cpu"].detect_words(imgs[k]),
                               slots["word_departures"], TFN_FUSE_LIMIT)
        cpu_rows.append({"page": TFN_PAGES[k], "word_pixels_off": int(word_px.sum()),
                         "char_pixels_off": int(char_px.sum()), "slots": slots,
                         "words": words,
                         "within_limits": slots["within_limits"] and words["within_limits"]})
    golden_ok, golden_rows = tfn_golden_rule(
        found, [(dense, _valid_slots(st)) for dense, st in card], g, to_map)
    tfn_engines = {dev: PipelineOcrEngine(bps[dev], recognizers[dev])
                   for dev in ("cuda", "cpu")}
    eng_pages = imgs[:DETECTOR_CPU_PAGES]
    _reset_counts()
    card_res, eng_ms = _timed_pages(lambda ps: tfn_engines["cuda"].extract(ps), [eng_pages])
    card_res = card_res[0]
    launches["textfusenet"] = _read_counts()
    cpu_res = tfn_engines["cpu"].extract(eng_pages)
    same, moved, one_sided, text_off = _words_compare(
        card_res, cpu_res, [r["words"]["departures"] for r in cpu_rows])
    mask_px = [int((c[0]["word"][..., 0] > g["low_text"]).sum()) for c in card]
    cpu_ok = gap <= limit and all(r["within_limits"] for r in cpu_rows)
    check("textfusenet", block_err <= DETECTOR_BLOCK_LIMIT and cpu_ok and golden_ok
          and min(mask_px) > 0 and sum(len(b) for b, _ in found) > 0 and same
          and sum(len(r["words"]) for r in card_res) > 0,
          {"pages": list(TFN_PAGES), "detector_ms_per_page": det_ms,
           "engine_ms_per_page": eng_ms / len(eng_pages),
           "engine_recognizer": "trained TrOCR, float32", "thresholds": g["thresholds"],
           "block_err": block_err, "block_limit": DETECTOR_BLOCK_LIMIT,
           "card_cpu_map_gap": gap, "gap_limit": limit, "departure_cap": DEPARTURE_CAP,
           "mask_pixels": mask_px,
           "boxes": [len(b) for b, _ in found], "cpu": cpu_rows, "golden": golden_rows,
           "engine_words": sum(len(r["words"]) for r in card_res),
           "engine_within_rule": same, "engine_boxes_moved": moved,
           "engine_one_sided": one_sided, "engine_text_off": text_off,
           "launches": launches["textfusenet"]})
    if failed:
        raise AssertionError(f"detectors outside their limits: {failed}")
    setups.update(detectors_ink=(engines["cuda"], pages[:DETECTOR_CPU_PAGES]),
                  detectors_textfusenet=(tfn_engines["cuda"], eng_pages))
    return launches, setups


READING_ORDER_SEED = SEED + 70  # the seeded base-width reading-order tree
LONG_PAGE_SEED = SEED + 71
LONG_PAGE_WORDS = 600  # three bands of max_boxes 256
READING_ORDER_LIMIT = 1e-4  # card vs golden scores (float32; K2 as 3xTF32)
SWAP_GAP = 2e-4  # a swapped neighbour pair's golden scores differ by less


def long_page_boxes(n: int = LONG_PAGE_WORDS, seed: int = LONG_PAGE_SEED):
    """xyxy boxes of ``n`` words on a 768x1024 page in two columns of
    lines, word widths and line heights drawn from ``seed``; each box is
    a list of four floats."""
    import numpy as np

    rng = np.random.default_rng(seed)
    boxes, col, x, y = [], 0, 40.0, 30.0
    for _ in range(n):
        w = float(rng.integers(18, 70))
        if x + w > 40 + 340 * col + 320:
            x, y = 40.0 + 340 * col, y + float(rng.integers(14, 20))
            if y > 1000:
                col, x, y = col + 1, 40.0 + 340 * (col + 1), 30.0
        h = float(rng.integers(10, 15))
        boxes.append([x, y, x + w, y + h])
        x += w + float(rng.integers(4, 12))
    return boxes


#: near-tie swaps allowed, at the counts the card showed: (a) against the
#: golden over the 17 pages (the CPU port shows the same swap), (b) card
#: against the CPU over the trained engine's 16 pages
READING_ORDER_SWAPS = 1
READING_ORDER_CPU_SWAPS = 0
READING_ORDER_LAUNCHES = 4  # K2 calls a band: one a layer


def _order_rows(layout, cases, wants, limit, gap):
    """Order each (boxes, scale) of ``cases`` with ``layout`` and hold it
    to ``wants`` ({"order", "scores"}): scores within ``limit``, orders
    equal but for near-tie swaps (``check.order_swaps`` at ``gap``).
    Returns (worst score gap, swaps, orders)."""
    import numpy as np

    from marie_tpu_torch.check import order_swaps

    worst, swaps, orders = 0.0, 0, []
    for (boxes, scale), want in zip(cases, wants):
        got, scores = layout.order_and_scores(boxes, scale)
        worst = max(worst, float(np.abs(scores - np.asarray(want["scores"], np.float32)).max()))
        swaps += order_swaps(got, want["order"], want["scores"], gap)
        orders.append(got)
    if not worst <= limit:
        raise AssertionError(f"reading-order scores off by {worst} > {limit}")
    return worst, swaps, orders


def phase_reading_order(shipped, trained_engine):
    """The reading-order model at its full width (``ReadingOrderConfig.
    base()``: hidden 128, 4 layers, 4 heads, so K2 float32 at D=32) with
    the seeded tree of ``golden_reading_order.json`` (the trained tree is
    not shipped): (a) on the card, the golden OCR words of the 16 shipped
    pages and the 600-word page (three bands) against the JAX golden:
    scores within READING_ORDER_LIMIT, orders equal but for adjacent swaps
    of near ties (golden scores closer than SWAP_GAP), at most
    READING_ORDER_SWAPS; (b) ``reorder_page_result`` on the trained
    engine's results of the 16 pages, card against the CPU port under the
    same rule; (c) ms/page, and K2 launched 4 times a band on the
    ``"reading_order"`` path (64 for the 16 pages).  Returns the launches
    of the 16-page run."""
    import torch

    from marie_tpu_torch.document.layoutreader import page_word_boxes, reorder_page_result
    from marie_tpu_torch.models.reading_order import ReadingOrderConfig, TextLayout
    from marie_tpu_torch.registry.convert import init_flax_layout
    from marie_tpu_torch.registry.zoo import open_zoo_json

    with open_zoo_json("golden_reading_order") as f:
        golden = json.load(f)
    if golden["settings"]["seed"] != READING_ORDER_SEED:
        raise AssertionError("golden_reading_order.json is of another seed")
    cfg = ReadingOrderConfig.base()
    tree = init_flax_layout(cfg, READING_ORDER_SEED)
    card = TextLayout(cfg, tree, device="cuda")
    cpu = TextLayout(cfg, tree, device="cpu")
    cases = [page_word_boxes(p) for p in shipped["golden"]["pages"]]
    n = len(cases)
    card.order(*cases[0])  # first call: builds the kernel
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    for boxes, scale in cases:
        card.order_and_scores(boxes, scale)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counts()
    ms_page = statistics.median(
        _ms_per_call(lambda b=b, s=s: card.order(b, s), reps=3)[0] for b, s in cases)
    long_boxes = long_page_boxes()
    _reset_counts()
    worst, swaps, _ = _order_rows(card, cases + [(long_boxes, 1024.0)],
                                  golden["pages"] + [golden["long_page"]],
                                  READING_ORDER_LIMIT, SWAP_GAP)
    long_launches = _read_counts()["flash_attention"].get("reading_order", 0)
    # (b): the trained engine's own results, card against the CPU port
    results = trained_engine.extract(list(shipped["pages"]))
    engine_cases = [page_word_boxes(r) for r in results]
    cpu_rows = []
    for boxes, scale in engine_cases:
        order, scores = cpu.order_and_scores(boxes, scale)
        cpu_rows.append({"order": order, "scores": scores})
    cpu_worst, cpu_swaps, card_orders = _order_rows(card, engine_cases, cpu_rows,
                                                    READING_ORDER_LIMIT, SWAP_GAP)
    same_dicts = 0
    for r, card_order, row in zip(results, card_orders, cpu_rows):
        got, want = reorder_page_result(r, card), reorder_page_result(r, cpu)
        if card_order == row["order"]:
            if got != want:
                raise AssertionError("reorder_page_result differs where the orders agree")
            same_dicts += 1
        if [w["id"] for w in got["words"]] != list(range(len(r["words"]))):
            raise AssertionError("reorder_page_result gave the words other ids")
    k2 = launches["flash_attention"]
    bands = n  # every shipped page is one band (< 256 words)
    emit({"phase": "reading_order", "config": "base (hidden 128, 4 layers, 4 heads, D=32)",
          "seed": READING_ORDER_SEED, "pages": n,
          "words": [len(b) for b, _ in cases], "long_page_words": len(long_boxes),
          "ms_per_page": ms_page, "wall_ms_per_page": wall / n * 1e3,
          "golden_max_score_err": worst, "golden_swaps": swaps,
          "cpu_max_score_err": cpu_worst, "cpu_swaps": cpu_swaps,
          "reorder_dicts_equal": same_dicts, "limit": READING_ORDER_LIMIT,
          "swap_gap": SWAP_GAP, "launches": launches, "long_page_launches": long_launches})
    if swaps > READING_ORDER_SWAPS or cpu_swaps > READING_ORDER_CPU_SWAPS:
        raise AssertionError(f"reading order: {swaps} golden, {cpu_swaps} CPU near-tie swaps")
    if (k2.get("reading_order", 0) != READING_ORDER_LAUNCHES * bands
            or k2.get("all", 0) != k2.get("reading_order", 0)
            or long_launches != READING_ORDER_LAUNCHES * (bands + 3)):
        raise AssertionError(f"reading order K2 launches: {launches}, {long_launches}")
    return launches


TRAIN_SEED = 0  # the training scripts' default seed
TRAIN_DATASET = 2048  # the layout trainers' default dataset size
CHAIN_SEQ_LEN = 192  # scripts/train_chain_heads.py's max_seq_len
EVAL_PAGES = 64  # evaluate_reading_order's pages
TRAIN_BWD_LIMIT = 1e-4  # dq, dk, dv vs autograd of the plain version, of the largest |grad|
TRAIN_LOSS_LIMIT = 1e-5  # one step card vs CPU: loss (relative)
TRAIN_GRAD_LIMIT = 1e-4  # each gradient leaf, of its largest magnitude
TRAIN_PARAM_LIMIT = 1e-5  # the updated parameters (absolute), where the gradient resolves
TRAIN_NOISE = 1e-6  # leaves the loss does not depend on: |grad| of the largest gradient
TRAIN_GATE = 0.03  # held-out metrics: at least the JAX-trained zoo tree's less this
TRAIN_STEP_LR = 3e-4  # the trainers' peak learning rate, constant for the one-step check
BASE_STEPS = 5
#: K2's gradient at the trainers' shapes: (name, (B, H, Sq, Skv, D), causal,
#: kv_len source: the trainers' own data, or a list)
TRAIN_K2_CASES = [
    ("reading_order_b32", (32, 4, 256, 256, 32), False, "reading_order"),
    ("reading_order_b64", (64, 4, 256, 256, 32), False, "reading_order"),
    ("splitter_synth", (32, 4, 128, 128, 64), False, "splitter"),
    ("chain_heads", (32, 4, 192, 192, 64), False, "chain"),
    ("classifier_base", (8, 12, 512, 512, 64), False, "base"),
    ("causal_d64", (8, 4, 160, 128, 64), True, [128, 0, 100, 64, 1, 128, 37, 90]),
    # the recognizer's teacher-forced step (fast_v3_g2_d6, batch 128): the
    # encoder's 20 patch tokens, the decoder's causal self-attention over
    # the 31 input tokens; no kv_len (None), as the model calls K2
    ("recognizer_encoder", (128, 6, 20, 20, 64), False, None),
    ("recognizer_decoder", (128, 6, 31, 31, 64), True, None),
    # the DiT trainer's step (dit_synth_s1, batch 8): 768 patch tokens, no mask
    ("dit_train", (8, 4, 768, 768, 64), False, None),
]
#: the cases of TRAIN_K2_CASES the ``ocr_train`` phase times (``train`` the rest)
OCR_K2_CASES = ("recognizer_encoder", "recognizer_decoder", "dit_train")

#: ``ocr_train``: the trees, the recognizer recipe of scripts/round4_chain4.sh,
#: and the held-out sets of golden_train.json's "ocr" entry
OCR_TREES = {"recognizer": "trocr-fast3g2d6ov-synth", "crnn": "crnn-synth",
             "craft": "craft-s2d2-synth"}
RECOGNIZER_RECIPE = dict(rotate_deg=2.0, text_mode="open", font_sizes=(14, 18, 20, 24, 30),
                         bold_p=0.35, shear_p=0.15)
OCR_HELDOUT_SEED = TRAIN_SEED + 9999  # train_recognizer_device's held-out seed
OCR_EVAL_CROPS = 512
CRNN_WIDTH = 256  # train_crnn_device's crop width
CRAFT_PAGE_HW = (512, 384)  # train_craft_device's pages
CRAFT_EVAL_PAGES = 32
RENDER_FIDELITY = 0.01  # the zoo tree's CER on the port's renders, against PIL's golden
CRAFT_LOSS_FIDELITY = 1e-3  # relative: the zoo CRAFT's held-out loss, against the golden's
#: CRAFT's float32 card step against its float64 one: the largest gradient
#: difference, of its leaf's largest (PERF.md: the sound readings and the
#: planted faults' of scripts/craft_float32_gap.py)
CRAFT_FLOAT32_GAP = 0.10
#: relative: the fine-tuned CRAFT's held-out loss over the zoo tree's
#: (64 pages overfit in 200 steps; the planted faults' readings in PERF.md)
CRAFT_TUNED_SLACK = 0.07
ENGINE_DELTA = 0.03  # the fine-tuned CRAFT in the engine: recall and precision, of golden.json's
#: the warm starts: steps, the block they draw from, and a tenth of each
#: recipe's peak learning rate (the zoo trees are trained to the end of
#: their schedules; a fresh warmup to the full peak would first undo them)
OCR_WARM = {"recognizer": dict(steps=300, dataset_size=2048, learning_rate=3e-5),
            "crnn": dict(steps=300, dataset_size=2048, learning_rate=1e-4),
            "craft": dict(steps=200, dataset_size=64, learning_rate=5e-5)}
OCR_STEP_BATCH = {"recognizer": 16, "crnn": 16, "craft": 4}
OCR_COLD_STEPS = 40  # (d): steps from an untrained recognizer
BOUNDARY_EVAL_PAGES = 64  # evaluate_boundary's held-out scans
BOUNDARY_EVAL_SEED = TRAIN_SEED + 777  # train_boundary_device's held-out seed
#: (g): the boundary recipe (scripts/train_boundary.py's defaults: 3,000
#: steps, batch 16, 128 pages), its held-out gates against golden_train's
#: boundary-synth figures: IoU within BOUNDARY_IOU_GATE, corner MAE at most
#: BOUNDARY_MAE_FACTOR times it
BOUNDARY_STEPS = 3000
BOUNDARY_IOU_GATE = 0.03
BOUNDARY_MAE_FACTOR = 1.5
#: (g): DiT (dit_synth_s1) and TextFuseNet (synth_s2) from the seed at
#: their recipes' data settings: steps on a block of pages; the loss of the
#: last LOSS_WINDOW steps must average below that of the first
DETECTOR_RUN_STEPS = 200
DETECTOR_RUN_PAGES = 32
LOSS_WINDOW = 25
#: (f): the batches of the one-step checks
NEW_STEP_BATCH = {"boundary": 16, "dit": 8, "textfusenet": 4}
#: (f): every step is held in float64 on both sides, for the reason given
#: (each measured on the CPU: the float32 gradient's largest departure from
#: the float64 one, of its leaf's largest, against TRAIN_GRAD_LIMIT)
NEW_STEP_FLOAT64 = {
    "boundary": "the per-channel GroupNorm's fast variance E[x^2] - E[x]^2: the first "
                "convolution's float32 weight gradient is 1.2e-4 off float64",
    "dit": "pos_embed's gradient is a batch sum that cancels: 1.8e-5 off float64 in float32 "
           "on the CPU, 1.1e-4 on the card with the plain attention, 1.8e-3 with K2's "
           "3xTF32; K2 takes float32 only, so both sides run its plain version here (the "
           "kernels: part (e), the float32 step against float64 and the run)",
    "textfusenet": "the running statistics as constants of the forward: the deepest "
                   "stage's float32 gradients are 2.9e-4 off float64",
}

#: (f): each new trainer's float32 card step against its float64 card step
#: on the same tree and batch: the largest gradient departure of a leaf, of
#: its largest, over the leaves but those named in NEW_FLOAT32_UNGATED
#: (DiT's pos_embed: the batch sum that cancels, 1.0e-3-3.7e-3 sound,
#: reported only).  Each limit sits between the sound readings on four
#: batches and those of the planted faults (TF32 on, a bfloat16
#: normalisation variance) of scripts/trainer_float32_gap.py on an H100
#: (PERF.md §6): boundary 5.3e-6-7.4e-3 sound against 0.17 and 0.22 (its
#: per-channel GroupNorm's E[x^2] - E[x]^2 on the deep stages' few pixels),
#: DiT 9.5e-5-2.1e-4 against 1.6e-3 and 3.4e-3, TextFuseNet 6.5e-5-1.1e-3
#: against 3.3e-3 and 6.0e-3
NEW_FLOAT32_GAP = {"boundary": 0.03, "dit": 5e-4, "textfusenet": 2e-3}
NEW_FLOAT32_UNGATED = {"dit": ("backbone.pos_embed",)}

def _train_kv_len(source, b, s):
    """kv_len [B] of a case: the valid counts of the first ``b`` examples
    of the trainer's own data at TRAIN_SEED (reading order: a
    ``make_batch``; the heads: their training set's seq_len)."""
    import dataclasses

    import numpy as np
    import torch

    from marie_tpu_torch.components.word_tokenizer import HashWordTokenizer, RollingWordTokenizer
    from marie_tpu_torch.models.configs import LayoutLMConfig
    from marie_tpu_torch.train import layout as tl
    from marie_tpu_torch.train.reading_order import make_batch

    rng = np.random.default_rng(TRAIN_SEED)
    labels = tuple(tl.CLASS_POOLS)
    if source is None:
        return None
    if isinstance(source, list):
        lens = np.asarray(source)
    elif source == "reading_order":
        lens = make_batch(rng, b, s)[2]
    elif source == "splitter":
        cfg = LayoutLMConfig.synth(2)
        lens = tl.splitter_dataset(rng, b, HashWordTokenizer(cfg.vocab_size), cfg)[2]
    elif source == "chain":
        cfg = dataclasses.replace(LayoutLMConfig.synth(3), max_seq_len=s)
        lens = tl.classifier_dataset(rng, b, labels, RollingWordTokenizer(cfg.vocab_size), cfg,
                                     True)[2]
    else:
        cfg = LayoutLMConfig.base(3)
        lens = tl.classifier_dataset(rng, b, labels, HashWordTokenizer(cfg.vocab_size), cfg,
                                     False)[2]
    return torch.tensor(lens, dtype=torch.int32, device="cuda")


def _bwd_work(mask, h, d):
    """(bytes, flops) the gradient must move and do: q and do read, dq, dk
    and dv written in full, lse read; of k and v the keys some row sees;
    per seen (query, key) pair 10 D flops (S and dP recomputed, dV, dK,
    dQ), per fully masked row 2 D Skv (its uniform P into dV)."""
    b, _, sq, skv = mask.shape
    seen = mask[:, 0].any(dim=1)
    blind = int((~mask[:, 0].any(dim=2)).sum())  # rows that see no key
    kv_rows = int(seen.sum())
    nbytes = 4 * h * (b * sq * d * 3 + b * skv * d * 2 + 2 * kv_rows * d + b * sq) + 4 * b
    flops = h * (10 * d * int(mask.sum()) + 2 * d * skv * blind)
    return nbytes, flops


def _train_kernel_rows(names, phase: str = "train"):
    """(a): K2's gradient kernel against autograd of the plain version on
    the card at the TRAIN_K2_CASES named; times cold and warm, the bound,
    the plain version's and SDPA forward + backward (the record's
    yardstick).  Returns {case: its kernels-line row}."""
    import torch
    import torch.nn.functional as F

    from marie_tpu_torch.ops.kernels import flash_attention as k2
    from marie_tpu_torch.utils.device import card_name_and_power_limit

    card = card_name_and_power_limit()
    rows = {}
    for i, (name, (b, h, sq, skv, d), causal, source) in enumerate(TRAIN_K2_CASES):
        if name not in names:
            continue
        kv_len = _train_kv_len(source, b, skv)
        scale = d ** -0.5
        nbytes_in = 4 * (b * h * (2 * sq + 2 * skv) * d)
        copies = n_copies(2 * nbytes_in)

        def make(c):
            q, k, v = _attn_inputs(b, h, sq, skv, d, torch.float32, SEED + 200 + i + 100 * c, True)
            do = _attn_inputs(b, h, sq, sq, d, torch.float32, SEED + 300 + i + 100 * c, True)[0]
            return q, k, v, k2.flash_attention_lse(q, k, v, kv_len, causal)[1], do

        ins = [make(c) for c in range(copies)]
        q, k, v, lse, do = ins[0]
        got = k2.flash_attention_backward(q, k, v, lse, do, kv_len, causal)
        want = k2.attention_backward_reference(q, k, v, do, causal=causal, kv_len=kv_len,
                                               sm_scale=scale)
        torch.cuda.synchronize()
        errs = [float((a - w).abs().max()) / float(w.abs().max()) for a, w in zip(got, want)]
        if not max(errs) <= TRAIN_BWD_LIMIT:
            raise AssertionError(f"K2 backward {name} disagrees with its plain version: "
                                 f"dq, dk, dv {errs} > {TRAIN_BWD_LIMIT}")
        t_kernel = timed(lambda c: k2.flash_attention_backward(*ins[c], kv_len, causal), copies)
        t_plain = timed(lambda c: k2.attention_backward_reference(
            *ins[c][:3], ins[c][4], causal=causal, kv_len=kv_len, sm_scale=scale), copies)

        def fwd_bwd(c):
            leaves = [t.detach().requires_grad_(True) for t in ins[c][:3]]
            k2.flash_attention(*leaves, kv_len=kv_len, causal=causal).backward(ins[c][4])
            return leaves

        mask = _sdpa_mask(b, sq, skv, kv_len, causal)
        lib_mask = None if bool(mask.all()) else mask

        def sdpa(c):
            leaves = [t.detach().requires_grad_(True) for t in ins[c][:3]]
            F.scaled_dot_product_attention(*leaves, attn_mask=lib_mask).backward(ins[c][4])
            return leaves

        with torch.enable_grad():
            t_fwd_bwd = timed(fwd_bwd, copies)
            t_lib = timed(sdpa, copies)
        del ins
        nbytes, flops = _bwd_work(mask, h, d)
        bound_bytes = nbytes / H100_BYTES_PER_S * 1e3
        bound_ops = flops / H100_FLOPS["3xtf32"] * 1e3
        entry = {"name": "flash_attention_backward", "route": "cuda",
                 "source": "marie_tpu_torch/csrc/flash_attention_bwd.cu",
                 "replaces": "marie_tpu/ops/pallas/flash_attention.py:112 (its gradient: "
                             "jax.grad of _attention_reference, flash_attention.py:30)",
                 "max_abs_err": max(errs), "ms": t_kernel["cold"], "plain_ms": t_plain["cold"],
                 "bound_ms": max(bound_bytes, bound_ops),
                 "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
                 "library_ms": t_lib["cold"]}
        emit({"phase": phase, "part": "k2_backward", "case": name, "card": card,
              "shape": [b, h, sq, skv, d], "causal": causal,
              "kv_len_mean": float(skv if kv_len is None else kv_len.float().mean()),
              "rel_err": errs,
              "limit": TRAIN_BWD_LIMIT, "copies": copies, "bound_bytes": nbytes,
              "bound_flops": flops, "warm_ms": t_kernel["warm"],
              "plain_warm_ms": t_plain["warm"], "fwd_bwd_ms": t_fwd_bwd["cold"],
              "fwd_bwd_warm_ms": t_fwd_bwd["warm"],
              "library": "SDPA forward + backward" + (" with attn_mask" if lib_mask is not None
                                                      else ""),
              "library_warm_ms": t_lib["warm"],
              "bound_simt_ms": max(bound_bytes, flops / H100_FLOPS["fp32"] * 1e3), **entry})
        rows[name] = entry
    return rows


def _invariant_param(name: str, kind: str) -> bool:
    """Parameters the loss does not depend on: the attention key biases
    (softmax is shift invariant in each row); for the reading-order
    ranker, the score head's and ``ln_f``'s biases (they shift every score
    alike, and the loss sees only differences); for CRAFT, a convolution's
    bias right before a batch-statistics BatchNorm (the batch mean takes
    it out again); for the boundary regressor, a convolution's bias before
    its per-channel GroupNorm (the same)."""
    return (name.endswith("kv.k.bias")
            or (kind == "ranker" and name in ("head.bias", "ln_f.bias"))
            or (kind == "craft" and name.endswith("Conv_0.bias")
                and not name.startswith("head_out"))
            or (kind == "boundary" and name.startswith("Conv_") and name.endswith(".bias")))


def _one_step(model, loss_fn, batch, lr, weight_decay, clip_norm=None, trainable=None,
              after=None):
    """One AdamW step at the constant learning rate ``lr`` over
    ``trainable`` (default: every parameter), clipped first where
    ``clip_norm`` is given; ``after(model)`` runs after it (CRAFT's
    running-statistics update).  Returns (loss, {name: grad}, {name:
    updated tensor}, {name: BatchNorm running statistic}), the tensors
    copied to the host in float64."""
    import numpy as np
    import torch

    from marie_tpu_torch.ops.kernels._build import launch_path
    from marie_tpu_torch.train.loop import StepTrainer
    from marie_tpu_torch.utils.device import float32_precision

    tensors = dict(model.named_parameters())
    if trainable is not None:
        ids = {id(t) for t in trainable}
        tensors.update(model.named_buffers())
        tensors = {n: t for n, t in tensors.items() if id(t) in ids}
    trainer = StepTrainer(model, loss_fn, lambda count: np.float32(lr), weight_decay=weight_decay,
                          clip_norm=clip_norm, params=trainable)
    with float32_precision(False), launch_path("train"):
        out = loss_fn(*batch)
        loss = out[0] if isinstance(out, tuple) else out
        loss.backward()
    grads = {n: t.grad.detach().double().cpu() if t.grad is not None
             else torch.zeros(t.shape, dtype=torch.float64) for n, t in tensors.items()}
    trainer.opt.step()
    if after is not None:
        after(model)
    params = {n: t.detach().double().cpu() for n, t in tensors.items()}
    stats = {n: b.detach().double().cpu() for n, b in model.named_buffers()
             if n.endswith(("running_mean", "running_var"))}
    return float(loss.detach()), grads, params, stats


def _step_card_vs_cpu(name, config, tree, make, data, kind, weight_decay, launches,
                      head=None, phase="train", lr=TRAIN_STEP_LR, clip_norm=None,
                      dtype_name="float32", after=None):
    """(b) for one model: one AdamW step (``_one_step``) on the card and
    the CPU from the same flax-layout ``tree`` and batch ``data`` (numpy;
    floating arrays cast to ``dtype_name``).  ``make(model)`` gives (the
    loss function, the tensors to step or None for every parameter).
    Holds the loss, every gradient leaf, the updated parameters where the
    gradient resolves, the BatchNorm running statistics, no leaf the loss
    reaches left without a gradient on the card, and K2's forward and
    gradient launched ``launches`` times each on ``"train"``."""
    import torch

    from marie_tpu_torch.train import batchnorm
    from marie_tpu_torch.train.loop import init_module
    from marie_tpu_torch.utils.device import card_name_and_power_limit

    dtype = getattr(torch, dtype_name)
    runs = {}
    for dev in ("cuda", "cpu"):
        model = init_module(config, head, 0, tree, dev).to(dtype)
        loss_fn, trainable = make(model)
        batch = [torch.from_numpy(a).to(next(model.parameters()).device) for a in data]
        batch = [b.to(dtype) if b.is_floating_point() else b for b in batch]
        _reset_counts()
        try:
            runs[dev] = _one_step(model, loss_fn, batch, lr, weight_decay, clip_norm, trainable,
                                  after)
        finally:
            batchnorm.restore(model)
        if dev == "cuda":
            torch.cuda.synchronize()
            counts = _read_train_counts()
        del model
    (l_card, g_card, p_card, s_card), (l_cpu, g_cpu, p_cpu, s_cpu) = runs["cuda"], runs["cpu"]
    top = max(float(g.abs().max()) for g in g_cpu.values())
    grad_err, param_err, noise, dropped = 0.0, 0.0, 0.0, []
    # Adam's first step moves a parameter by lr * g / (|g| + eps), about lr
    # whatever g's size: where a gradient component is below what the
    # gradient check resolves (TRAIN_GRAD_LIMIT of its leaf's largest), card
    # and CPU may step apart by up to 2 lr; those are held to that and counted
    band_err, band_count, elements = 0.0, 0, 0
    for n, g in g_cpu.items():
        elements += g.numel()
        diff = (p_card[n] - p_cpu[n]).abs()
        if _invariant_param(n, kind):
            noise = max(noise, float(g.abs().max()) / top, float(g_card[n].abs().max()) / top)
            band_err = max(band_err, float(diff.max()))
            continue
        if float(g_card[n].abs().max()) == 0.0:
            dropped.append(n)
        leaf_top = float(g.abs().max())
        grad_err = max(grad_err, float((g_card[n] - g).abs().max()) / leaf_top)
        resolved = g.abs() >= TRAIN_GRAD_LIMIT * leaf_top
        param_err = max(param_err, float(diff[resolved].max()))
        band_count += int((~resolved & (g != 0)).sum())
        if bool((~resolved).any()):
            band_err = max(band_err, float(diff[~resolved].max()))
    stats_err = max((float((s_card[n] - s_cpu[n]).abs().max()) for n in s_cpu), default=0.0)
    loss_err = abs(l_card - l_cpu) / abs(l_cpu)
    row = {"model": name, "dtype": dtype_name, "batch": len(data[0]), "loss_card": l_card,
           "loss_cpu": l_cpu, "loss_rel_err": loss_err, "grad_rel_err": grad_err,
           "param_err": param_err, "bn_stats_err": stats_err, "invariant_noise": noise,
           "unresolved_nonzero_grads": band_count, "elements": elements,
           "unresolved_param_err": band_err, "dropped": dropped, "leaves": len(g_cpu),
           "launches": counts}
    emit({"phase": phase, "part": "step_card_vs_cpu", "card": card_name_and_power_limit(), **row,
          "limits": {"loss": TRAIN_LOSS_LIMIT, "grad": TRAIN_GRAD_LIMIT,
                     "param": TRAIN_PARAM_LIMIT, "bn_stats": TRAIN_PARAM_LIMIT,
                     "noise": TRAIN_NOISE, "unresolved_param": 2 * lr}})
    if (loss_err > TRAIN_LOSS_LIMIT or grad_err > TRAIN_GRAD_LIMIT
            or param_err > TRAIN_PARAM_LIMIT or stats_err > TRAIN_PARAM_LIMIT
            or noise > TRAIN_NOISE or dropped or band_err > 2 * lr):
        raise AssertionError(f"{name} step card vs CPU outside the limits: {row}")
    if (counts["flash_attention"].get("train", 0) != launches
            or counts["flash_attention_backward"].get("train", 0) != launches):
        raise AssertionError(f"{name} step launches: {counts}")
    return row


def _read_train_counts():
    from marie_tpu_torch.ops.kernels.flash_attention import flash_attention_backward

    counts = _read_counts()
    counts["flash_attention_backward"] = {"all": flash_attention_backward.launches,
                                          **flash_attention_backward.launches_by_path}
    return counts


def _timed_run(label, fn, expect_fwd, expect_bwd):
    """Run a trainer with the counts reset before and read after, peak
    memory tracked; fails unless K2 launched forward and backward the
    predicted times, all on ``"train"``.  Returns (result, row, counts)."""
    import torch

    timing = {}
    _reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn(timing)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_train_counts()
    fwd, bwd = counts["flash_attention"], counts["flash_attention_backward"]
    if (fwd.get("all", 0) != expect_fwd or bwd.get("all", 0) != expect_bwd
            or fwd.get("all", 0) != fwd.get("train", 0)
            or bwd.get("all", 0) != bwd.get("train", 0)):
        raise AssertionError(f"{label}: K2 launches {counts}, predicted forward {expect_fwd} "
                             f"and backward {expect_bwd} on \"train\"")
    row = {"steps": timing["steps"], "ms_per_step": timing["ms_per_step"],
           "steps_per_s": timing["steps_per_s"], "train_s": timing["train_s"], "wall_s": wall,
           "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
           "k2_forward_launches": fwd.get("train", 0),
           "k2_backward_launches": bwd.get("train", 0)}
    if "pages_per_s" in timing:  # the trainer's host renderer
        row["host_pages_per_s"] = timing["pages_per_s"]
    return out, row, counts


def _gate(label, got, want):
    if not got >= want - TRAIN_GATE:
        raise AssertionError(f"{label}: held-out {got} below the JAX-trained tree's {want} "
                             f"less {TRAIN_GATE}")


def _layout_steps_card_vs_cpu():
    """``train`` (b): one step, card against CPU, of a ``LayoutLMConfig.
    synth(2)`` splitter and of the ``ReadingOrderConfig.base()`` ranker."""
    import numpy as np

    from marie_tpu_torch.components.word_tokenizer import HashWordTokenizer
    from marie_tpu_torch.models.configs import LayoutLMConfig
    from marie_tpu_torch.models.reading_order import ReadingOrderConfig
    from marie_tpu_torch.registry.convert import init_flax_defaults
    from marie_tpu_torch.train import layout as tl
    from marie_tpu_torch.train import reading_order as tr

    cfg = LayoutLMConfig.synth(2)
    rng = np.random.default_rng(TRAIN_SEED)
    _step_card_vs_cpu("splitter synth(2)", cfg,
                      init_flax_defaults(cfg, TRAIN_SEED + 90, "sequence"),
                      lambda model: (tl.head_loss(model, "sequence"), None),
                      tl.splitter_dataset(rng, 32, HashWordTokenizer(cfg.vocab_size), cfg),
                      "layout", 0.01, cfg.num_layers, head="sequence")
    rcfg = ReadingOrderConfig.base()

    def ranker(model):
        return (lambda boxes, ranks, n_valid: tr.pairwise_rank_loss(
            model(boxes, n_valid), ranks, n_valid)), None

    _step_card_vs_cpu("reading order base", rcfg, init_flax_defaults(rcfg, TRAIN_SEED + 90),
                      ranker, tr.make_batch(np.random.default_rng(TRAIN_SEED), 32, 256), "ranker",
                      1e-4, rcfg.num_layers)


def phase_train(shipped, trained_engine):
    """Training on the card.  (a) K2's gradient kernel against its plain
    version at the trainers' shapes (``_train_kernel_rows``); (b) one AdamW
    step of a ``LayoutLMConfig.synth(2)`` splitter and of the
    ``ReadingOrderConfig.base()`` ranker, card against CPU on the same tree
    and batch: loss, every gradient leaf, the updated parameters, and no
    leaf the loss reaches without a gradient on the card; (c) the splitter
    at ``scripts/train_splitter.py``'s settings, its tree saved through
    ``to_flax`` and reloaded into ``LayoutDocumentSplitter`` (logits equal
    to the trained module's); (d) the chained heads at
    ``scripts/train_chain_heads.py``'s settings, then swapped into the
    trained engine on the 16 shipped pages (agreement with the golden,
    reported); (e) the reading-order ranker at
    ``scripts/train_reading_order.py``'s settings on the device pool; (f)
    5 steps of the classifier at LayoutLMv3-base width (S=512, batch 8):
    ms/step and peak memory.  (c)-(e) are gated by ``golden_train.json``:
    each held-out metric at least the JAX-trained zoo tree's less
    TRAIN_GATE.  Returns (the kernels line's row, launches by run)."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np
    import torch

    from marie_tpu_torch.check import agreement
    from marie_tpu_torch.components.base import PageInput
    from marie_tpu_torch.components.document_classifier import LayoutDocumentClassifier
    from marie_tpu_torch.components.document_classifier.layoutlm_classifier import (
        SYNTH_CLASS_LABELS)
    from marie_tpu_torch.components.document_indexer import LayoutDocumentIndexer
    from marie_tpu_torch.components.document_indexer.layoutlm_indexer import SYNTH_NER_LABELS
    from marie_tpu_torch.components.document_splitter import LayoutDocumentSplitter
    from marie_tpu_torch.components.word_tokenizer import HashWordTokenizer, RollingWordTokenizer
    from marie_tpu_torch.logging_core import MarieLogger
    from marie_tpu_torch.models.configs import LayoutLMConfig
    from marie_tpu_torch.models.reading_order import ReadingOrderConfig
    from marie_tpu_torch.ops.kernels._build import launch_path
    from marie_tpu_torch.registry.checkpoints import load_params
    from marie_tpu_torch.registry.zoo import open_zoo_json
    from marie_tpu_torch.train import layout as tl
    from marie_tpu_torch.train import reading_order as tr
    from marie_tpu_torch.train.loop import init_module
    from marie_tpu_torch.utils.device import float32_precision

    with open_zoo_json("golden_train") as f:
        golden = json.load(f)
    if (golden["settings"]["seed"] != TRAIN_SEED or golden["settings"]["dataset_size"]
            != TRAIN_DATASET or golden["settings"]["chain_max_seq_len"] != CHAIN_SEQ_LEN):
        raise AssertionError("golden_train.json is of other settings")
    row = _train_kernel_rows([c[0] for c in TRAIN_K2_CASES
                              if c[0] not in OCR_K2_CASES])["reading_order_b64"]

    _layout_steps_card_vs_cpu()  # (b)

    launches = {}
    # (c) the splitter at its script's defaults
    tmp = tempfile.mkdtemp(prefix="marie-train-")
    try:
        path = os.path.join(tmp, "layout-splitter.npz")
        (model, _, metrics, cfg), run, launches["train_splitter"] = _timed_run(
            "splitter", lambda timing: tl.train_layout_splitter(
                checkpoint_path=path, device="cuda", timing=timing), (1500 + 1) * 4, 1500 * 4)
        splitter = LayoutDocumentSplitter(config=cfg, params=load_params(path), device="cuda")
        prng = np.random.default_rng(TRAIN_SEED + 5)
        pages = [PageInput(*tl.synth_split_page(prng, i % 3 == 0)) for i in range(8)]
        clf = splitter.classifier
        with torch.no_grad(), launch_path("heads"), float32_precision(False):
            inputs = clf._encode_batch(pages)
            mine = model(*inputs)[:len(pages)]
        reloaded = clf.logits(pages)
        same = bool(torch.equal(mine, reloaded))
        emit({"phase": "train", "part": "splitter", **run, **metrics,
              "jax_tree": golden["splitter"], "npz_bytes": os.path.getsize(path),
              "reloaded_logits_equal": same})
        if not same:
            raise AssertionError("the reloaded splitter tree gives other logits")
        for key in ("page_acc", "split_acc"):
            _gate(f"splitter {key}", metrics[key], golden["splitter"][key])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del model, splitter

    # (d) the chained heads, then in the trained engine
    heads = {}
    for kind, labels in (("classifier", SYNTH_CLASS_LABELS), ("indexer", SYNTH_NER_LABELS)):
        ccfg = dataclasses.replace(LayoutLMConfig.synth(len(labels)), max_seq_len=CHAIN_SEQ_LEN)
        trainer = tl.train_layout_classifier if kind == "classifier" else tl.train_layout_indexer
        (model, params, acc, _), run, launches[f"train_chain_{kind}"] = _timed_run(
            f"chain {kind}", lambda timing, trainer=trainer, ccfg=ccfg, labels=labels: trainer(
                labels=labels, config=ccfg, tokenizer=RollingWordTokenizer(ccfg.vocab_size),
                shuffle_words=True, steps=2000, device="cuda", timing=timing), (2000 + 1) * 4,
            2000 * 4)
        want = golden[f"{kind}_chain"]["accuracy" if kind == "classifier" else "token_accuracy"]
        emit({"phase": "train", "part": f"chain_{kind}", **run,
              ("accuracy" if kind == "classifier" else "token_accuracy"): acc,
              "jax_tree": golden[f"{kind}_chain"]})
        _gate(f"chain {kind}", acc, want)
        heads[kind] = (ccfg, labels, params)
        del model
    saved = trained_engine.classifier, trained_engine.indexer
    try:
        (ccfg, labels, params) = heads["classifier"]
        trained_engine.classifier = LayoutDocumentClassifier(
            labels=labels, config=ccfg, params=params,
            tokenizer=RollingWordTokenizer(ccfg.vocab_size), device="cuda")
        (ncfg, nlabels, nparams) = heads["indexer"]
        trained_engine.indexer = LayoutDocumentIndexer(
            labels=nlabels, config=ncfg, params=nparams,
            tokenizer=RollingWordTokenizer(ncfg.vocab_size), device="cuda")
        results = trained_engine.extract(list(shipped["pages"]))
    finally:
        trained_engine.classifier, trained_engine.indexer = saved
    agree = agreement(shipped["golden"]["pages"], results)
    emit({"phase": "train", "part": "chain_in_engine", "pages": len(results),
          "page_label_agreement": agree["labels"], "ner_label_agreement": agree["ner"],
          "word_agreement": agree["words"],
          "note": "report only: the golden's labels come from the JAX-trained heads"})

    # (e) reading order on the device pool
    (model, _, pair_acc, tau), run, launches["train_reading_order"] = _timed_run(
        "reading order", lambda timing: tr.train_reading_order_device(
            steps=3000, batch_size=64, pool_pages=4096, device="cuda", timing=timing),
        (3000 + 1) * 4, 3000 * 4)
    rcfg = ReadingOrderConfig.base()
    boxes, ranks, n_valid = tr.make_batch(np.random.default_rng(TRAIN_SEED + 1), EVAL_PAGES,
                                          rcfg.max_boxes)
    scores = torch.from_numpy(tr.score_boxes(model, boxes, n_valid))
    _, held_pair = tr.pairwise_rank_loss(scores, torch.from_numpy(ranks),
                                         torch.from_numpy(n_valid))
    emit({"phase": "train", "part": "reading_order", **run, "pair_acc_last_batch": pair_acc,
          "kendall_tau": tau, "heldout_pair_accuracy": float(held_pair),
          "jax_tree": golden["reading_order"]})
    _gate("reading order tau", tau, golden["reading_order"]["kendall_tau"])
    _gate("reading order pair accuracy", float(held_pair),
          golden["reading_order"]["pair_accuracy"])
    del model

    # (f) the classifier at LayoutLMv3-base width: its training steps alone
    bcfg = LayoutLMConfig.base(len(tl.CLASS_POOLS))
    data = tl.classifier_dataset(np.random.default_rng(TRAIN_SEED), 64, tl.CLASS_POOLS,
                                 HashWordTokenizer(bcfg.vocab_size), bcfg, False)
    model = init_module(bcfg, "sequence", TRAIN_SEED, device="cuda")
    torch.cuda.synchronize()
    base_mib = torch.cuda.memory_allocated() / 2**20
    _, run, launches["train_classifier_base"] = _timed_run(
        "base classifier", lambda timing: timing.update(tl.train_head(
            model, "sequence", data, steps=BASE_STEPS, batch_size=8, dataset_size=64,
            learning_rate=3e-4, steps_per_dispatch=BASE_STEPS, seed=TRAIN_SEED,
            logger=MarieLogger("train-classifier")).timing()), BASE_STEPS * bcfg.num_layers,
        BASE_STEPS * bcfg.num_layers)
    emit({"phase": "train", "part": "classifier_base", **run, "batch": 8,
          "seq_len": bcfg.max_seq_len, "kv_len_mean": float(data[2][:8].mean()),
          "params": sum(p.numel() for p in model.parameters()), "weights_mib": base_mib})
    del model
    torch.cuda.empty_cache()
    return row, launches


def _ocr_step_card_vs_cpu(kind: str, config, tree, data, dtype_name: str = "float32"):
    """(b) for one OCR model: ``_step_card_vs_cpu`` with its trainer's step
    (clip 1.0, its weight decay, its peak learning rate held constant).
    The CRNN steps its BatchNorm running statistics as parameters; CRAFT
    normalises with the batch statistics and moves the running ones as
    flax does after the step."""
    from marie_tpu_torch.train import batchnorm
    from marie_tpu_torch.train.craft import craft_loss
    from marie_tpu_torch.train.crnn import crnn_loss, crnn_trainable
    from marie_tpu_torch.train.recognizer import recognizer_loss

    def make(model):
        model.train()
        if kind == "recognizer":
            return recognizer_loss(model, config.decoder.pad_id), None
        if kind == "crnn":
            return crnn_loss(model), crnn_trainable(model)
        batchnorm.use_batch_statistics(model)
        return craft_loss(model), None

    lr, decay = {"recognizer": (3e-4, 0.01), "crnn": (1e-3, 1e-4), "craft": (5e-4, 1e-4)}[kind]
    launches = 2 * config.encoder.num_layers if kind == "recognizer" else 0
    return _step_card_vs_cpu(kind, config, tree, make, data, kind, decay, launches,
                             phase="ocr_train", lr=lr, clip_norm=1.0, dtype_name=dtype_name,
                             after=batchnorm.update_running_statistics if kind == "craft"
                             else None)


def _craft_float32_gap(config, tree, batch, device="cuda") -> float:
    """CRAFT's float32 gradient on ``device`` against its float64 gradient
    there, on the same tree and batch (batch statistics, as the trainer
    steps): the largest difference of a leaf, of that leaf's largest
    (the convolution biases the loss does not depend on aside)."""
    return _new_trainer_float32_gap("craft", config, tree, batch, device)["gaps"][0][0]


def _engine_quality(shipped, craft_tree):
    """The serving engine (``zoo_engine``'s detector settings and TrOCR, no
    heads) with ``craft_tree`` as its detector, on the 16 shipped pages:
    recall, precision, mean IoU and CER against the truth."""
    from marie_tpu_torch.boxes.craft_box_processor import BoxProcessorCraft
    from marie_tpu_torch.models.configs import CraftConfig
    from marie_tpu_torch.ocr.ocr_engine import PipelineOcrEngine
    from marie_tpu_torch.ocr.util import trocr_processor

    bp = BoxProcessorCraft(config=CraftConfig.fast_s2d2(), variables=craft_tree,
                           box_source="heatmap", text_threshold=0.6, low_text=0.4,
                           link_threshold=0.4, max_components=256, param_dtype="bfloat16",
                           cc_runs=32, device="cuda")
    engine = PipelineOcrEngine(bp, trocr_processor(device="cuda", batch_sizes=(32, 128, 256)),
                               upload_format="u2", compact_slots=160, page_fuse_batch=16)
    pages = list(shipped["pages"])
    results = engine.extract(pages)
    _check_results(results, len(pages), *pages[0].shape)
    return _quality(results, shipped["truth"]["pages"], pages[0].shape)


def phase_ocr_train(shipped):
    """The OCR trainers on the card (their data drawn by the glyph atlas
    and the numpy PIL operations on the host).  (a) K2 and its gradient
    at the recognizer's two shapes against their plain versions
    (``_train_kernel_rows``); (b) one AdamW step card against CPU of the
    recognizer (``fast_v3_g2_d6``, untrained, batch 16), the CRNN
    (``crnn-synth``'s configuration, untrained, batch 16) and CRAFT
    (``fast_s2d2``, the zoo tree, batch 4; in float64 on both sides: the
    float32 step's batch statistics are ill-conditioned), and CRAFT's
    float32 card step within CRAFT_FLOAT32_GAP of its float64 one; (c)
    warm starts from ``torch_zoo/``'s trees at the recipes' data settings:
    the zoo tree's held-out CER on the port's renders within
    RENDER_FIDELITY of ``golden_train.json``'s (measured on PIL's), the
    fine-tuned tree's within TRAIN_GATE of it, the fine-tuned CRAFT's
    held-out loss at most CRAFT_TUNED_SLACK over the zoo tree's and, in
    the serving engine on the 16 shipped pages, recall and precision no
    lower than golden.json's less ENGINE_DELTA, K2
    launched as predicted; (d) OCR_COLD_STEPS steps of an untrained
    recognizer, its loss reported.  Returns {run: launches}."""
    import numpy as np
    import torch

    from marie_tpu_torch.models.configs import CraftConfig, CRNNConfig, TrOCRConfig
    from marie_tpu_torch.models.tokenizer import CharTokenizer, CTCCharTokenizer
    from marie_tpu_torch.registry.convert import init_flax_defaults
    from marie_tpu_torch.registry.zoo import open_zoo_json, zoo_params
    from marie_tpu_torch.train import craft as tcr
    from marie_tpu_torch.train import crnn as trn
    from marie_tpu_torch.train import recognizer as trec
    from marie_tpu_torch.train.loop import init_module
    from marie_tpu_torch.utils.device import card_name_and_power_limit, cudnn_benchmark

    with open_zoo_json("golden_train") as f:
        golden = json.load(f)["ocr"]
    st = golden["settings"]
    if (st["heldout_seed"] != OCR_HELDOUT_SEED or st["crops"] != OCR_EVAL_CROPS
            or st["craft_pages"] != CRAFT_EVAL_PAGES or st["crnn_width"] != CRNN_WIDTH):
        raise AssertionError("golden_train.json's ocr entry is of other settings")
    card = card_name_and_power_limit()
    launches = {}
    kernel_rows = _train_kernel_rows(OCR_K2_CASES, phase="ocr_train")

    # (b) one step, card against CPU
    rcfg, ccfg, kcfg = TrOCRConfig.fast_v3_g2_d6(), CRNNConfig(), CraftConfig.fast_s2d2()
    tok, ctok = CharTokenizer(), CTCCharTokenizer()
    imgs, toks = trec.render_block(rcfg, tok, TRAIN_SEED + 91, OCR_STEP_BATCH["recognizer"],
                                   **RECOGNIZER_RECIPE)
    _ocr_step_card_vs_cpu("recognizer", rcfg, init_flax_defaults(rcfg, TRAIN_SEED + 90),
                          (imgs.astype(np.float32) / 255.0, toks))
    cimgs, labs, lens = trn.render_crnn_block(trn._crnn_render_config(CRNN_WIDTH, 32), ctok,
                                              TRAIN_SEED + 91, OCR_STEP_BATCH["crnn"])
    with cudnn_benchmark():  # as train_crnn_device steps
        _ocr_step_card_vs_cpu("crnn", ccfg, init_flax_defaults(ccfg, TRAIN_SEED + 90),
                              (cimgs.astype(np.float32) / 255.0, labs, lens))
    pages, targets = tcr.render_pages(np.random.default_rng(TRAIN_SEED + 91),
                                      OCR_STEP_BATCH["craft"], CRAFT_PAGE_HW, kcfg.out_stride)
    craft_batch = (pages.astype(np.float32) / 255.0, targets.astype(np.float32) / 255.0)
    craft_zoo = zoo_params(OCR_TREES["craft"])
    _ocr_step_card_vs_cpu("craft", kcfg, craft_zoo, craft_batch, "float64")
    # the float32 step the trainer takes, against the float64 one
    gap = _craft_float32_gap(kcfg, craft_zoo, craft_batch)
    emit({"phase": "ocr_train", "part": "craft_float32_step", "card": card,
          "grad_rel_err_vs_float64": gap, "limit": CRAFT_FLOAT32_GAP})
    if not gap <= CRAFT_FLOAT32_GAP:
        raise AssertionError(f"CRAFT's float32 step is {gap} off its float64 step "
                             f"(limit {CRAFT_FLOAT32_GAP})")

    # (c) the recognizer: the zoo tree on the port's held-out renders, then a warm start
    held = trec.SyntheticWordDataset(rcfg, tok, seed=OCR_HELDOUT_SEED, noise=0.0,
                                     rotate_deg=RECOGNIZER_RECIPE["rotate_deg"], lowres_p=0.0,
                                     text_mode=RECOGNIZER_RECIPE["text_mode"],
                                     font_sizes=RECOGNIZER_RECIPE["font_sizes"])
    t0 = time.perf_counter()
    h_imgs, _, h_texts = held.sample(OCR_EVAL_CROPS)
    crops_per_s = OCR_EVAL_CROPS / (time.perf_counter() - t0)
    rec_zoo = zoo_params(OCR_TREES["recognizer"])
    model = init_module(rcfg, None, 0, rec_zoo, "cuda").eval()
    zoo_cer = trec.decode_cer(model, h_imgs, h_texts, tok)
    del model
    want = golden["recognizer"]["cer"]
    warm = OCR_WARM["recognizer"]
    layers = rcfg.encoder.num_layers + rcfg.decoder.num_layers
    losses = []
    (model, _, cer), run, launches["ocr_train_recognizer"] = _timed_run(
        "recognizer", lambda timing: trec.train_recognizer_device(
            config=rcfg, batch_size=128, steps_per_dispatch=50, noise=0.03, seed=TRAIN_SEED,
            eval_samples=OCR_EVAL_CROPS, refresh_every=0, init_params=rec_zoo, device="cuda",
            timing=timing, losses=losses, **warm, **RECOGNIZER_RECIPE),
        warm["steps"] * layers + rcfg.encoder.num_layers, warm["steps"] * layers)
    emit({"phase": "ocr_train", "part": "recognizer", "card": card, **run, **warm,
          "batch": 128, "tree": OCR_TREES["recognizer"], "zoo_cer_port_renders": zoo_cer,
          "golden_cer_pil_renders": want, "finetuned_cer": cer,
          "loss_first": losses[0], "loss_last": losses[-1],
          "host_crops_per_s": crops_per_s, "limits": {"fidelity": RENDER_FIDELITY,
                                                      "gate": TRAIN_GATE}})
    if abs(zoo_cer - want) > RENDER_FIDELITY:
        raise AssertionError(f"the zoo recognizer reads the port's renders at CER {zoo_cer}, "
                             f"PIL's at {want}")
    if cer > want + TRAIN_GATE:
        raise AssertionError(f"the fine-tuned recognizer's CER {cer} > {want} + {TRAIN_GATE}")
    del model
    torch.cuda.empty_cache()

    # the CRNN
    crnn_held = trec.SyntheticWordDataset(trn._crnn_render_config(CRNN_WIDTH, 32),
                                          seed=OCR_HELDOUT_SEED, noise=0.0, lowres_p=0.0)
    c_imgs, _, c_texts = crnn_held.sample(OCR_EVAL_CROPS)
    crnn_zoo = zoo_params(OCR_TREES["crnn"])
    model = init_module(ccfg, None, 0, crnn_zoo, "cuda").eval()
    crnn_zoo_cer = trn.crnn_cer(model, c_imgs, c_texts, ctok)
    del model
    want = golden["crnn"]["cer"]
    warm = OCR_WARM["crnn"]
    losses = []
    (model, _, _), run, launches["ocr_train_crnn"] = _timed_run(
        "crnn", lambda timing: trn.train_crnn_device(
            config=ccfg, batch_size=128, width=CRNN_WIDTH, steps_per_dispatch=50,
            refresh_every=0, seed=TRAIN_SEED, init_params=crnn_zoo, device="cuda",
            timing=timing, losses=losses, **warm), 0, 0)
    cer = trn.crnn_cer(model, c_imgs, c_texts, ctok)
    emit({"phase": "ocr_train", "part": "crnn", "card": card, **run, **warm, "batch": 128,
          "tree": OCR_TREES["crnn"], "zoo_cer_port_renders": crnn_zoo_cer,
          "golden_cer_pil_renders": want, "finetuned_cer": cer, "loss_first": losses[0],
          "loss_last": losses[-1]})
    if abs(crnn_zoo_cer - want) > RENDER_FIDELITY:
        raise AssertionError(f"the zoo CRNN reads the port's renders at CER {crnn_zoo_cer}, "
                             f"PIL's at {want}")
    if cer > want + TRAIN_GATE:
        raise AssertionError(f"the fine-tuned CRNN's CER {cer} > {want} + {TRAIN_GATE}")
    del model
    torch.cuda.empty_cache()

    # CRAFT
    t0 = time.perf_counter()
    h_pages, h_targets = tcr.render_pages(np.random.default_rng(OCR_HELDOUT_SEED),
                                          CRAFT_EVAL_PAGES, CRAFT_PAGE_HW, kcfg.out_stride)
    pages_per_s = CRAFT_EVAL_PAGES / (time.perf_counter() - t0)
    model = init_module(kcfg, None, 0, craft_zoo, "cuda").eval()
    zoo_loss = tcr.craft_heldout_loss(model, h_pages, h_targets)
    del model
    want = golden["craft"]["weighted_mse"]
    warm = OCR_WARM["craft"]
    losses = []
    (model, variables), run, launches["ocr_train_craft"] = _timed_run(
        "craft", lambda timing: tcr.train_craft_device(
            config=kcfg, batch_size=4, page_hw=CRAFT_PAGE_HW, steps_per_dispatch=25,
            refresh_every=0, seed=TRAIN_SEED, init_params=craft_zoo, device="cuda",
            timing=timing, losses=losses, **warm), 0, 0)
    tuned_loss = tcr.craft_heldout_loss(model, h_pages, h_targets)
    del model
    # the engine's device thread makes its own cuBLAS handle: give the
    # trainers' cached blocks back to CUDA first
    torch.cuda.empty_cache()
    quality = _engine_quality(shipped, variables)
    golden_quality = _quality(shipped["golden"]["pages"], shipped["truth"]["pages"],
                              shipped["pages"][0].shape)
    emit({"phase": "ocr_train", "part": "craft", "card": card, **run, **warm, "batch": 4,
          "tree": OCR_TREES["craft"], "zoo_loss_port_pages": zoo_loss,
          "golden_loss_pil_pages": want, "finetuned_loss": tuned_loss,
          "loss_first": losses[0], "loss_last": losses[-1], "host_pages_per_s": pages_per_s,
          "engine": quality, "golden_engine": golden_quality,
          "limits": {"loss_fidelity": CRAFT_LOSS_FIDELITY, "tuned_slack": CRAFT_TUNED_SLACK,
                     "engine": ENGINE_DELTA}})
    if abs(zoo_loss - want) > CRAFT_LOSS_FIDELITY * want:
        raise AssertionError(f"the zoo CRAFT's held-out loss on the port's pages {zoo_loss}, "
                             f"on PIL's {want}")
    if not tuned_loss <= (1.0 + CRAFT_TUNED_SLACK) * zoo_loss:
        raise AssertionError(f"the fine-tuned CRAFT's held-out loss {tuned_loss} > the zoo "
                             f"tree's {zoo_loss} x (1 + {CRAFT_TUNED_SLACK})")
    for key in ("recall", "precision"):
        if quality[key] < golden_quality[key] - ENGINE_DELTA:
            raise AssertionError(f"the fine-tuned CRAFT's {key} {quality[key]} < "
                                 f"{golden_quality[key]} - {ENGINE_DELTA}")
    del variables

    # (d) an untrained recognizer: the loss falls (report only)
    losses = []
    (_, _, cold_cer), run, launches["ocr_train_cold"] = _timed_run(
        "cold recognizer", lambda timing: trec.train_recognizer_device(
            config=rcfg, steps=OCR_COLD_STEPS, batch_size=128, dataset_size=1024,
            steps_per_dispatch=OCR_COLD_STEPS // 4, seed=TRAIN_SEED, eval_samples=64,
            refresh_every=0, device="cuda", timing=timing, losses=losses,
            **RECOGNIZER_RECIPE),
        OCR_COLD_STEPS * layers + rcfg.encoder.num_layers, OCR_COLD_STEPS * layers)
    emit({"phase": "ocr_train", "part": "cold_recognizer", "card": card, **run,
          "loss_first": losses[0], "loss_last": losses[-1], "loss_fell": losses[-1] < losses[0],
          "cer": cold_cer, "note": "report only"})
    torch.cuda.empty_cache()

    # (f) one step card against CPU of the boundary, DiT and TextFuseNet
    # trainers, then (g) their runs from the seed
    _new_trainer_steps()
    _new_trainer_runs(card, launches)
    return kernel_rows, launches


def _new_trainer_batches(batch_seed=TRAIN_SEED + 91):
    """(f)'s seeded trees and batches (numpy, host-drawn; the data from
    ``batch_seed`` and ``batch_seed + 1``, the trees from TRAIN_SEED + 90): the boundary
    regressor at ``BoundaryConfig()`` (scans composited on the host from
    a seeded CPU generator), DiT at ``dit_synth_s1`` (the served
    detector's configuration; ``render_block``'s pages and targets) and
    TextFuseNet at ``synth_s2`` (``render_page_tfn``'s pages, the stride-2
    head's targets, the stride-4 segmentation, boxes, and seeded jitter and
    shifts)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from marie_tpu_torch.models.configs import BoundaryConfig, TextFuseNetConfig, ViTConfig
    from marie_tpu_torch.registry.convert import init_flax_defaults
    from marie_tpu_torch.train import boundary as tb
    from marie_tpu_torch.train import dit as td
    from marie_tpu_torch.train import textfusenet as tt

    out = {}
    bcfg = BoundaryConfig()
    n = NEW_STEP_BATCH["boundary"]
    gen = torch.Generator().manual_seed(batch_seed + 1)
    docs = torch.from_numpy(tb.render_docs(batch_seed, n, bcfg.input_hw))
    scans, quads = tb._make_scan(gen, docs, bcfg.input_hw)
    out["boundary"] = (bcfg, init_flax_defaults(bcfg, TRAIN_SEED + 90),
                       (scans.numpy(), quads.numpy()))
    dcfg = ViTConfig.dit_synth_s1()
    pages, targets = td.render_block(batch_seed, NEW_STEP_BATCH["dit"],
                                     tuple(dcfg.image_size), dcfg.head_stride)
    out["dit"] = (dcfg, init_flax_defaults(dcfg, TRAIN_SEED + 90),
                  (pages.astype(np.float32) / 255.0, targets.astype(np.float32) / 255.0))
    fcfg = TextFuseNetConfig.synth_s2()
    b = NEW_STEP_BATCH["textfusenet"]
    pages, targets, wb, wv, cb, cv = tt.render_dataset(batch_seed, b, CRAFT_PAGE_HW,
                                                       fcfg.max_words, fcfg.max_chars)
    t2 = torch.from_numpy(targets.astype(np.float32) / 255.0)
    t4 = F.max_pool2d(t2.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1).numpy()
    rng = np.random.default_rng(batch_seed + 1)
    jitter = rng.uniform(-0.15, 0.15, (b, fcfg.max_words, 4)).astype(np.float32)
    shift = rng.uniform(40.0, 120.0, (b, fcfg.max_words, 2)).astype(np.float32)
    out["textfusenet"] = (fcfg, init_flax_defaults(fcfg, TRAIN_SEED + 90),
                          (pages.astype(np.float32) / 255.0, t2.numpy(), t4[..., 3], wb, wv, cb,
                           cv, jitter, shift))
    return out


def _plain_attention():
    """The port's plain attention (``attention_reference``, float64 for
    float64 inputs) in the models' attention (``models/layers.py``), for a
    float64 step on the card: the kernels take float32 and bf16 only, and
    their wrappers raise on any other card tensor."""
    import marie_tpu_torch.models.layers as layers
    from marie_tpu_torch.ops.kernels import flash_attention as fa

    def plain(q, k, v, kv_len=None, causal=False, sm_scale=None):
        return fa.attention_reference(q, k, v, causal=causal, kv_len=kv_len,
                                      sm_scale=fa._scale(q.shape[3], sm_scale))

    @contextlib.contextmanager
    def swapped():
        saved = layers.flash_attention
        layers.flash_attention = plain
        try:
            yield
        finally:
            layers.flash_attention = saved

    return swapped()


def _new_trainer_loss(kind, model):
    """(the loss function, the tensors to step or None for every
    parameter) of ``kind``'s trainer: the boundary's corner loss, DiT's
    and CRAFT's weighted MSE (``craft_loss``; CRAFT's with batch
    statistics, as its trainer steps) and TextFuseNet's loss with its
    BatchNorm running statistics stepped as parameters, as its JAX trainer
    does (``train=False``, every leaf stepped)."""
    import torch

    from marie_tpu_torch.train import batchnorm
    from marie_tpu_torch.train.boundary import boundary_loss
    from marie_tpu_torch.train.craft import craft_loss
    from marie_tpu_torch.train.textfusenet import tfn_loss

    if kind == "boundary":
        ih, iw = model.cfg.input_hw
        p = next(model.parameters())
        norm = torch.tensor([iw - 1.0, ih - 1.0], dtype=p.dtype, device=p.device)
        return boundary_loss(model, norm), None
    if kind == "craft":
        batchnorm.use_batch_statistics(model)
    if kind in ("dit", "craft"):
        return craft_loss(model), None
    return tfn_loss(model), list(model.parameters()) + batchnorm.train_running_statistics(model)


def _new_trainer_float32_gap(kind, cfg, tree, data, device="cuda"):
    """``kind``'s float32 step on ``device`` (DiT's through K2 and its
    gradient on the card) against its float64 step there (DiT's through
    the plain attention) on the same tree and batch, no TF32: {the two
    losses, each gradient leaf's largest departure of that leaf's largest
    (worst first; the leaves the loss does not depend on aside), the
    float32 step's launches}."""
    import torch

    from marie_tpu_torch.train import batchnorm
    from marie_tpu_torch.train.loop import init_module

    runs = {}
    for dtype in (torch.float32, torch.float64):
        model = init_module(cfg, None, 0, tree, device).to(dtype)
        loss_fn, trainable = _new_trainer_loss(kind, model)
        batch = [torch.from_numpy(a).to(device) for a in data]
        batch = [b.to(dtype) if b.is_floating_point() else b for b in batch]
        _reset_counts()
        with contextlib.ExitStack() as stack:
            if dtype == torch.float64 and kind == "dit" and device == "cuda":
                stack.enter_context(_plain_attention())
            try:
                runs[dtype] = _one_step(model, loss_fn, batch, TRAIN_STEP_LR, 0.0, 1.0,
                                        trainable)[:2]
            finally:
                batchnorm.restore(model)
        if dtype == torch.float32:
            if device == "cuda":
                torch.cuda.synchronize()
            counts = _read_train_counts()
        del model
    (l32, g32), (l64, g64) = runs[torch.float32], runs[torch.float64]
    gaps = sorted(((float((g32[n] - g).abs().max() / g.abs().max()), n) for n, g in g64.items()
                   if not _invariant_param(n, kind)), reverse=True)
    return {"loss_float32": l32, "loss_float64": l64, "loss_rel_err": abs(l32 - l64) / abs(l64),
            "gaps": gaps, "launches": counts}


def _gated_gap(kind, gaps):
    """The gap NEW_FLOAT32_GAP holds: the worst leaf but those named in
    NEW_FLOAT32_UNGATED."""
    return max(g for g, n in gaps if n not in NEW_FLOAT32_UNGATED.get(kind, ()))


def _new_trainer_float32_row(kind, cfg, tree, data):
    """(f): ``kind``'s float32 card step against its float64 card step
    (``_new_trainer_float32_gap``): the loss within TRAIN_LOSS_LIMIT, the
    gated gradient gap within NEW_FLOAT32_GAP, K2 and its gradient launched
    once a layer for DiT and never for the others."""
    from marie_tpu_torch.utils.device import card_name_and_power_limit

    got = _new_trainer_float32_gap(kind, cfg, tree, data)
    gaps, counts = got.pop("gaps"), got["launches"]
    gated = _gated_gap(kind, gaps)
    row = {"phase": "ocr_train", "part": "float32_vs_float64", "model": kind,
           "card": card_name_and_power_limit(), **got, "grad_gap_gated": gated,
           "grad_gap_largest": gaps[:3], "grad_gap_median": gaps[len(gaps) // 2][0],
           "ungated": list(NEW_FLOAT32_UNGATED.get(kind, ())),
           "limits": {"loss": TRAIN_LOSS_LIMIT, "grad_gap_gated": NEW_FLOAT32_GAP[kind]}}
    emit(row)
    if got["loss_rel_err"] > TRAIN_LOSS_LIMIT or not gated <= NEW_FLOAT32_GAP[kind]:
        raise AssertionError(f"{kind}'s float32 card step is off its float64 one: {row}")
    k2 = cfg.num_layers if kind == "dit" else 0
    if (counts["flash_attention"].get("train", 0) != k2
            or counts["flash_attention_backward"].get("train", 0) != k2):
        raise AssertionError(f"{kind}'s float32 card step launches: {counts}")
    return row


def _new_trainer_steps():
    """(f): one AdamW step card against CPU of the boundary regressor, DiT
    and TextFuseNet (``_step_card_vs_cpu``: their trainers' losses, clip
    1.0, weight decay 1e-4, their peak learning rates held constant), each
    in float64 on both sides (NEW_STEP_FLOAT64 says why; DiT's through the
    plain attention), then each float32 card step against the float64 card
    step (``_new_trainer_float32_row``; DiT's with K2)."""
    import torch

    from marie_tpu_torch.utils.device import card_name_and_power_limit

    rows = {}
    rates = {"boundary": 4e-4, "dit": 3e-4, "textfusenet": 3e-4}
    for kind, (cfg, tree, data) in _new_trainer_batches().items():
        emit({"phase": "ocr_train", "part": "step_in_float64", "model": kind,
              "card": card_name_and_power_limit(), "why": NEW_STEP_FLOAT64[kind]})
        with contextlib.ExitStack() as stack:
            if kind == "dit":
                stack.enter_context(_plain_attention())
            rows[kind] = _step_card_vs_cpu(kind, cfg, tree,
                                           functools.partial(_new_trainer_loss, kind), data,
                                           kind, 1e-4, 0, phase="ocr_train", lr=rates[kind],
                                           clip_norm=1.0, dtype_name="float64")
        rows[f"{kind}_float32"] = _new_trainer_float32_row(kind, cfg, tree, data)
        torch.cuda.empty_cache()
    return rows


def _loss_fell(label, losses):
    first = sum(losses[:LOSS_WINDOW]) / LOSS_WINDOW
    last = sum(losses[-LOSS_WINDOW:]) / LOSS_WINDOW
    if not last < first:
        raise AssertionError(f"{label}: the last {LOSS_WINDOW} steps' mean loss {last} is not "
                             f"below the first {LOSS_WINDOW}'s {first}")
    return {"loss_first_mean": first, "loss_last_mean": last}


def _new_trainer_runs(card, launches):
    """(g): the boundary recipe from the seed (BOUNDARY_STEPS steps, batch
    16, 128 pages), its held-out figures gated by golden_train.json's
    ``boundary-synth`` ones; DiT (``dit_synth_s1``, batch 8) and
    TextFuseNet (``synth_s2``, batch 4) from the seed for
    DETECTOR_RUN_STEPS steps on DETECTOR_RUN_PAGES pages, their losses
    falling.  Each reports ms/step, the host renderer's pages/s, peak
    memory and K2's launches against the prediction: 6 forward and 6
    gradient a DiT step, none in the others."""
    import torch

    from marie_tpu_torch.models.configs import BoundaryConfig, TextFuseNetConfig, ViTConfig
    from marie_tpu_torch.registry.zoo import open_zoo_json
    from marie_tpu_torch.train import boundary as tb
    from marie_tpu_torch.train import dit as td
    from marie_tpu_torch.train import textfusenet as tt
    from marie_tpu_torch.train.loop import init_module

    with open_zoo_json("golden_train") as f:
        golden = json.load(f)["boundary"]
    if golden["pages"] != BOUNDARY_EVAL_PAGES or golden["seed"] != BOUNDARY_EVAL_SEED:
        raise AssertionError("golden_train.json's boundary entry is of other settings")
    bcfg = BoundaryConfig()
    untrained = tb.evaluate_boundary(init_module(bcfg, None, TRAIN_SEED, device="cuda").eval(),
                                     bcfg, BOUNDARY_EVAL_PAGES, BOUNDARY_EVAL_SEED)
    losses = []
    (model, _, metrics), run, launches["ocr_train_boundary"] = _timed_run(
        "boundary", lambda timing: tb.train_boundary_device(
            config=bcfg, steps=BOUNDARY_STEPS, batch_size=16, dataset_size=128,
            seed=TRAIN_SEED, device="cuda", timing=timing, losses=losses), 0, 0)
    emit({"phase": "ocr_train", "part": "boundary_run", "card": card, **run, "batch": 16,
          "dataset_size": 128, "heldout": metrics, "untrained": untrained, "golden": golden,
          "predicted_k2_launches": 0, **_loss_fell("boundary", losses),
          "limits": {"iou": BOUNDARY_IOU_GATE, "mae_factor": BOUNDARY_MAE_FACTOR}})
    if metrics["mean_quad_iou"] < golden["mean_quad_iou"] - BOUNDARY_IOU_GATE:
        raise AssertionError(f"the boundary run's held-out IoU {metrics['mean_quad_iou']} < "
                             f"{golden['mean_quad_iou']} - {BOUNDARY_IOU_GATE}")
    if metrics["corner_mae_px"] > BOUNDARY_MAE_FACTOR * golden["corner_mae_px"]:
        raise AssertionError(f"the boundary run's held-out corner error "
                             f"{metrics['corner_mae_px']} px > {BOUNDARY_MAE_FACTOR} x "
                             f"{golden['corner_mae_px']}")
    del model
    torch.cuda.empty_cache()

    dcfg = ViTConfig.dit_synth_s1()
    losses, steps = [], DETECTOR_RUN_STEPS
    (model, _), run, launches["ocr_train_dit"] = _timed_run(
        "dit", lambda timing: td.train_dit_device(
            config=dcfg, steps=steps, batch_size=8, dataset_size=DETECTOR_RUN_PAGES,
            refresh_every=0, seed=TRAIN_SEED, device="cuda", timing=timing, losses=losses),
        steps * dcfg.num_layers, steps * dcfg.num_layers)
    emit({"phase": "ocr_train", "part": "dit_run", "card": card, **run, "batch": 8,
          "dataset_size": DETECTOR_RUN_PAGES, "config": "dit_synth_s1",
          "predicted_k2_launches": steps * dcfg.num_layers, **_loss_fell("dit", losses)})
    del model
    torch.cuda.empty_cache()

    fcfg = TextFuseNetConfig.synth_s2()
    losses = []
    (model, _), run, launches["ocr_train_textfusenet"] = _timed_run(
        "textfusenet", lambda timing: tt.train_textfusenet_device(
            config=fcfg, steps=steps, batch_size=4, dataset_size=DETECTOR_RUN_PAGES,
            page_hw=CRAFT_PAGE_HW, seed=TRAIN_SEED, device="cuda", timing=timing,
            losses=losses), 0, 0)
    emit({"phase": "ocr_train", "part": "textfusenet_run", "card": card, **run, "batch": 4,
          "dataset_size": DETECTOR_RUN_PAGES, "config": "synth_s2", "predicted_k2_launches": 0,
          **_loss_fell("textfusenet", losses)})
    del model
    torch.cuda.empty_cache()


def phase_runtime(shipped, trained_engine):
    """The runtime glue on the card: an engine built with ``mesh="local"``
    gives the result dicts of ``mesh=None`` on 2 pages; ``TimeContextTPU``
    waits for work queued on the card (and ``TimeContext`` does not);
    ``collect_system_metrics`` reports the card's allocated bytes;
    ``get_full_version`` names the card; the numpy JPEG encoder and
    decoder and the G4 writer reproduce the sha256 of PIL's outputs in
    ``golden_reading_order.json``, and are timed."""
    import hashlib

    import numpy as np
    import torch

    from marie_tpu_torch.helper import get_full_version
    from marie_tpu_torch.logging_core.profile import TimeContext, TimeContextTPU
    from marie_tpu_torch.metrics import collect_system_metrics
    from marie_tpu_torch.ocr.ocr_engine import PipelineOcrEngine
    from marie_tpu_torch.registry.zoo import open_zoo_json
    from marie_tpu_torch.utils import image_io

    with open_zoo_json("golden_reading_order") as f:
        golden = json.load(f)
    e = trained_engine
    local = PipelineOcrEngine(e.box_processor, e.ocr_processor, upload_format=e.upload_format,
                              compact_slots=e.compact_slots,
                              page_fuse_batch=e.page_fuse_batch, mesh="local",
                              classifier=e.classifier, indexer=e.indexer)
    pages = list(shipped["pages"][:2])
    if local.mesh is not None or local.extract(pages) != e.extract(pages):
        raise AssertionError("mesh='local' does not give the mesh=None results")
    # a ~50 ms sleep kernel, then a small op behind it
    x = torch.ones(4, device="cuda")
    torch.cuda.synchronize()
    with TimeContext("no wait") as plain:
        torch.cuda._sleep(100_000_000)
        y = x + 1
    busy_after_plain = not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    with TimeContextTPU("wait", outputs_fn=lambda: [y]) as waited:
        torch.cuda._sleep(100_000_000)
        y = x + 2
    idle_after_wait = torch.cuda.current_stream().query()
    metrics = collect_system_metrics()
    version = get_full_version()
    name = torch.cuda.get_device_name(0)

    def sha(b):
        return hashlib.sha256(b).hexdigest()

    digests, times = {}, {}
    for key in ("page0", "rgb"):
        img = shipped["pages"][0] if key == "page0" else shipped["rgb"]
        t0 = time.perf_counter()
        data = image_io.encode_jpeg(img)
        t1 = time.perf_counter()
        decoded = image_io.decode_jpeg(data)
        t2 = time.perf_counter()
        want = golden["jpeg"][key]
        digests[f"jpeg_{key}"] = (sha(data) == want["bytes"]
                                  and sha(np.ascontiguousarray(decoded).tobytes())
                                  == want["decoded"]
                                  and list(decoded.shape) == want["shape"])
        times[f"jpeg_encode_{key}_ms"] = (t1 - t0) * 1e3
        times[f"jpeg_decode_{key}_ms"] = (t2 - t1) * 1e3
    for key in ("page0", "oversize"):
        frame = (shipped["pages"][0] if key == "page0" else shipped["oversize"]) > 128
        h, w = frame.shape
        per = image_io.g4_rows_per_strip(w, h)
        t0 = time.perf_counter()
        strips = [image_io.encode_g4(frame[r:r + per]) for r in range(0, h, per)]
        t1 = time.perf_counter()
        back = np.concatenate([image_io.decode_g4(st, w, min(per, h - i * per))
                               for i, st in enumerate(strips)])
        t2 = time.perf_counter()
        want = golden["g4"][key]
        digests[f"g4_{key}"] = (sha(b"".join(strips)) == want["strips"]
                                and len(strips) == want["count"]
                                and per == want["rows_per_strip"]
                                and bool(np.array_equal(back, frame)))
        times[f"g4_encode_{key}_ms"] = (t1 - t0) * 1e3
        times[f"g4_decode_{key}_ms"] = (t2 - t1) * 1e3
    row = {"mesh_local_equal": True, "time_context_s": plain.duration,
           "stream_busy_after_time_context": busy_after_plain,
           "time_context_tpu_s": waited.duration,
           "stream_idle_after_time_context_tpu": idle_after_wait,
           "device_bytes_in_use": metrics.get("device.bytes_in_use"),
           "metrics": sorted(metrics), "version": version, "digests": digests, **times}
    emit({"phase": "runtime", **row})
    failed = [k for k, ok in digests.items() if not ok]
    if (not busy_after_plain or not idle_after_wait or waited.duration < 0.02
            or not metrics.get("device.bytes_in_use", 0) > 0
            or version.get("device") != name or version.get("device_count") != 1
            or failed):
        raise AssertionError(f"runtime checks failed: {row}")


ROTATED_LIMIT = 1e-5
ROTATED_SEED = SEED + 80


def phase_rotated():
    """The rotated ops and deformable convolution on the card against the
    CPU port on the same inputs, within ROTATED_LIMIT (the NMS keep masks
    equal), each timed (warm, device): ``pairwise_rotated_iou`` on
    512 x 512 boxes at angles 0, 45, 90, -30 and drawn ones (with
    identical, contained and disjoint pairs), ``rotated_nms`` over 512
    boxes, ``roi_align_rotated`` of 256 rois on 2 maps of 64x100x100, and
    ``deform_conv2d`` v1 and v2 (32 -> 64 channels, 3x3, 2x64x64)."""
    import numpy as np
    import torch

    from marie_tpu_torch.ops.deform_conv import deform_conv2d
    from marie_tpu_torch.ops.nms import rotated_nms
    from marie_tpu_torch.ops.roi_align import roi_align_rotated
    from marie_tpu_torch.ops.rotated_iou import pairwise_rotated_iou

    rng = np.random.default_rng(ROTATED_SEED)
    n = 512
    angles = np.where(rng.random(n) < 0.5, rng.choice([0.0, 45.0, 90.0, -30.0], n),
                      rng.uniform(-90, 90, n))
    boxes = np.concatenate([rng.uniform(0, 400, (n, 2)), rng.uniform(4, 60, (n, 2)),
                            angles[:, None]], 1).astype(np.float32)
    boxes[1] = boxes[0]  # identical
    boxes[3] = boxes[2] * np.float32([1, 1, 0.3, 0.3, 1])  # contained
    boxes[5] = boxes[4] + np.float32([900, 900, 0, 0, 0])  # disjoint
    scores = rng.random(n).astype(np.float32)
    feats = rng.standard_normal((2, 64, 100, 100)).astype(np.float32)
    rois = np.concatenate([rng.integers(0, 2, (256, 1)), rng.uniform(0, 100, (256, 2)),
                           rng.uniform(2, 40, (256, 2)), rng.uniform(-90, 90, (256, 1))],
                          1).astype(np.float32)
    x = rng.standard_normal((2, 32, 64, 64)).astype(np.float32)
    wgt = (rng.standard_normal((64, 32, 3, 3)) / np.sqrt(288)).astype(np.float32)
    off = (rng.standard_normal((2, 18, 64, 64)) * 2).astype(np.float32)
    mask = rng.random((2, 9, 64, 64)).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    cases = {
        "pairwise_rotated_iou": lambda d: pairwise_rotated_iou(boxes, boxes, device=d),
        "rotated_nms": lambda d: rotated_nms(boxes, scores, 0.3, device=d)[0],
        "roi_align_rotated": lambda d: roi_align_rotated(feats, rois, 7, 0.5, 2, device=d),
        "deform_conv2d_v1": lambda d: deform_conv2d(x, off, wgt, None, bias, device=d),
        "deform_conv2d_v2": lambda d: deform_conv2d(x, off, wgt, mask, bias, device=d),
    }
    rows, failed = {}, []
    for name, fn in cases.items():
        got = fn("cuda")
        want = fn("cpu")
        torch.cuda.synchronize()
        if got.dtype == torch.bool:
            err = float((got.cpu() != want).sum())
            ok = err == 0 and bool(want.any())
        else:
            err = float((got.cpu() - want).abs().max())
            ok = err <= ROTATED_LIMIT
        ins = {k: torch.from_numpy(v).cuda() for k, v in dict(
            boxes=boxes, scores=scores, feats=feats, rois=rois, x=x, wgt=wgt, off=off,
            mask=mask, bias=bias).items()}
        dev_fn = {
            "pairwise_rotated_iou": lambda: pairwise_rotated_iou(ins["boxes"], ins["boxes"]),
            "rotated_nms": lambda: rotated_nms(ins["boxes"], ins["scores"], 0.3),
            "roi_align_rotated": lambda: roi_align_rotated(ins["feats"], ins["rois"], 7, 0.5,
                                                           2),
            "deform_conv2d_v1": lambda: deform_conv2d(ins["x"], ins["off"], ins["wgt"], None,
                                                      ins["bias"]),
            "deform_conv2d_v2": lambda: deform_conv2d(ins["x"], ins["off"], ins["wgt"],
                                                      ins["mask"], ins["bias"]),
        }[name]
        host_ms, _ = _ms_per_call(dev_fn, reps=5)
        rows[name] = {"max_abs_err": err, "device_ms": device_ms(dev_fn, reps=10),
                      "host_ms": host_ms, "shape": list(got.shape)}
        if not ok:
            failed.append(name)
    emit({"phase": "rotated", "limit": ROTATED_LIMIT, "ops": rows})
    if failed:
        raise AssertionError(f"rotated ops card vs CPU: {failed}: {rows}")


def _without_heads(pages):
    """Golden pages without the chained heads' outputs (page labels and
    NER labels), for runs of an engine without heads."""
    out = []
    for page in pages:
        page = {k: v for k, v in page.items() if k != "classification"}
        page["words"] = [{k: v for k, v in wd.items() if k not in ("ner_label", "ner_label_id",
                                                                   "ner_score")}
                         for wd in page["words"]]
        out.append(page)
    return out


SINGLE_PAGES = 2


def phase_single(shipped, trained_engine):
    """The single-page program (``fused_dispatch`` + ``fused_collect_many``,
    the JAX package's ``_fused_page``; ROADMAP item 4.3) on 2 shipped pages
    with the trained engine's detector and recogniser, twice: ms/page of
    the second run; the results within the golden's limits
    (``_against_golden``, the golden's head outputs set aside: this
    program runs no heads); K1 and K2 launched on ``"single"``.  Returns
    the launches of the second run."""
    import torch

    from marie_tpu_torch.enums import CoordinateFormat, PSMode
    from marie_tpu_torch.ocr.fused import fused_collect_many, fused_dispatch

    e = trained_engine
    bp, op = e.box_processor, e.ocr_processor
    pages = list(shipped["pages"][:SINGLE_PAGES])
    n, (h, w) = len(pages), pages[0].shape

    def run():
        handles = [fused_dispatch(bp, op, page) for page in pages]
        outs = fused_collect_many(bp, op, handles, [PSMode.SPARSE] * n)
        return [e._assemble_result(f, i, o, CoordinateFormat.XYWH)
                for i, (f, o) in enumerate(zip(pages, outs))], handles

    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    _reset_counts()
    t0 = time.perf_counter()
    results, handles = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counts()
    _check_results(results, n, h, w)
    row = _against_golden(results, _without_heads(shipped["golden"]["pages"][:n]),
                          shipped["truth"]["pages"][:n], (h, w))
    emit({"phase": "single", "pages": n, "page_hw": [h, w], "handles": [hd.kind for hd in handles],
          "rec_slots": handles[0].rec_slots, "first_call_s": first_s,
          "wall_ms_per_page": wall / n * 1e3,
          "kept_boxes": sum(len(r["words"]) for r in results), "launches": launches, **row})
    if not row["within_limits"]:
        raise AssertionError(f"the single-page program is outside the golden's limits: {row}")
    if (launches["crop_resize"].get("single", 0) != n
            or launches["flash_attention"].get("single", 0) <= 0):
        raise AssertionError(f"single-page launches: {launches}")
    return launches


SERVE_PAIRS = 8  # /document/extract requests of 2 pages: the 16 shipped pages
#: words (text or box) a served page may have apart from the in-process
#: pipeline's on the same pages (the child may pick other cuDNN algorithms)
SERVE_WORD_DIFFS = 0
SERVE_CLOSE_S = 10.0


def _word_diffs(got_pages, want_pages) -> int:
    """Words whose text or box differ, position by position, plus the
    words one side has past the other's."""
    n = 0
    for g, w in zip(got_pages, want_pages):
        gw = [(x["text"], tuple(x["box"])) for x in g["words"]]
        ww = [(x["text"], tuple(x["box"])) for x in w["words"]]
        n += sum(a != b for a, b in zip(gw, ww)) + abs(len(gw) - len(ww))
    return n


def _percentile(values, q: float) -> float:
    v = sorted(values)
    return v[min(int(round(q * (len(v) - 1))), len(v) - 1)]


def _served_launches(client) -> dict:
    """{kernel: {path: launches}} that a served worker's ``/metrics``
    reports for its process."""
    import re

    status, text = client.get("/metrics")
    if status != 200:
        raise AssertionError(f"/metrics answered {status}")
    counts: dict = {}
    for kernel, path, n in re.findall(
            r'^marie_kernel_launches_total\{kernel="(\w+)",path="(\w+)"\} (\d+)$', text, re.M):
        counts.setdefault(kernel, {})[path] = int(n)
    return counts


def _launch_delta(before: dict, after: dict) -> dict:
    return {k: {p: n - before.get(k, {}).get(p, 0) for p, n in paths.items()}
            for k, paths in after.items()}


def phase_serve(shipped, ner_tree):
    """The OCR executor served on the card by a worker pod over HTTP, and
    the NER executor in-process.

    (a) ``Pod("worker", uses="marie_tpu_torch.executor.TextExtractionExecutor",
    uses_with={"ocr_engine": "default", "device": "cuda", ...},
    protocol="http")``: startup seconds, ``/health`` 200, and
    ``/document/status`` names the card (the child's version table).
    (b) The 16 shipped pages as 8 ``/document/extract`` requests of 2
    pages (tensors in the JSON body, ``HTTPClient``), one after another:
    each 200 and ``"succeeded"``; the child's ``/metrics`` shows K1 and K2
    launched on ``"fused"`` in these requests; the 16 pages within the golden's limits
    (its head outputs set aside: the registry's ``default`` engine runs
    no heads); the words apart from an in-process ``ExtractPipeline`` on
    the same engine configuration and pages counted, at most
    SERVE_WORD_DIFFS.  (c) The same 8 requests, each from a client thread
    of its own, all in flight at once: all answered, each within SERVE_WORD_DIFFS of
    (b)'s; p50/p95 request ms, pages/s, JSON encode/decode ms.  (d) A
    request with no frames gets the JAX envelope ``{"status": "failed",
    "error": "no frames in request"}``.  (e) The child exits within
    SERVE_CLOSE_S of SIGTERM and its port is free again.  (f)
    ``NerExtractionExecutor(reading_order=True, indexer=<the seeded
    base-width indexer of layoutlm_base/extract>, device="cuda")`` through
    ``WorkerRequestHandler.process_data`` on the golden words of the 16
    pages: ``text_layout`` is set, the entities equal ``text_layout.order``
    then ``indexer.index`` called directly, and K2 launched on
    ``"heads"`` and ``"reading_order"``.  Returns the launches of (b) in
    the child and of (f), by path: ``{kernel: {"extract_<path>": n,
    "ner_<path>": n}}``."""
    import asyncio
    import socket
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from marie_tpu_torch.clients import HTTPClient
    from marie_tpu_torch.components.base import PageInput
    from marie_tpu_torch.components.document_indexer import LayoutDocumentIndexer
    from marie_tpu_torch.executor import NerExtractionExecutor
    from marie_tpu_torch.executor.ner_executor import reading_order_boxes
    from marie_tpu_torch.executor.text_extraction_executor import _trained_overlay
    from marie_tpu_torch.models.configs import LayoutLMConfig
    from marie_tpu_torch.ocr.util import get_known_ocr_engines
    from marie_tpu_torch.orchestrate.pods import Pod
    from marie_tpu_torch.pipe import ExtractPipeline
    from marie_tpu_torch.registry.zoo import open_zoo_json
    from marie_tpu_torch.serve.executors.decorators import _jsonify
    from marie_tpu_torch.serve.runtimes.worker.request_handling import WorkerRequestHandler
    from marie_tpu_torch.types import Document
    from marie_tpu_torch.types.request import DataRequest

    pages = list(shipped["pages"])
    n, (h, w) = len(pages), pages[0].shape
    pairs = [pages[2 * i:2 * i + 2] for i in range(SERVE_PAIRS)]
    card = torch.cuda.get_device_name(0)
    row = {"phase": "serve", "pages": n, "requests": SERVE_PAIRS}
    name = "extract"

    def envelope(body):
        if body["header"]["status"]["code"] != 0:
            raise AssertionError(f"request failed: {body['header']['status']}")
        return body["parameters"]["__results__"][name]

    with tempfile.TemporaryDirectory() as work_dir:
        pod = Pod("worker", uses="marie_tpu_torch.executor.TextExtractionExecutor",
                  uses_with={"ocr_engine": "default", "device": "cuda",
                             "work_dir": os.path.join(work_dir, "served")},
                  protocol="http", name=name)
        t0 = time.perf_counter()
        pod.start()
        row["startup_s"] = time.perf_counter() - t0
        try:
            client = HTTPClient(port=pod.port)
            health = client.get("/health")
            status = envelope(client.post("/document/status", [], return_responses=True))
            row["health"] = health[0]
            row["served_device"] = status["runtime_info"].get("device")
            if health != (200, {"status": "OK"}) or row["served_device"] != card:
                raise AssertionError(f"served worker: health {health}, status {status}")

            def request(pair, i, c=None):
                """(OCR pages, request ms, the client's JSON timings) of one
                request, on ``c`` or on a client of its own."""
                own = c is None
                c = c or HTTPClient(port=pod.port)
                try:
                    t = time.perf_counter()
                    body = c.post("/document/extract",
                                  [Document(id=f"p{i}-{k}", tensor=p) for k, p in enumerate(pair)],
                                  parameters={"ref_id": f"pair-{i}", "job_id": f"job-{i}"},
                                  return_responses=True)
                    ms = (time.perf_counter() - t) * 1e3
                finally:
                    if own:
                        c.close()
                env = envelope(body)
                if env.get("status") != "succeeded":
                    raise AssertionError(f"request {i}: {env}")
                _check_results(env["metadata"]["ocr"], len(pair), h, w)
                return env["metadata"]["ocr"], ms, dict(c.last_timings)

            # (b) one after another
            before = _served_launches(client)
            seq = [request(pair, i, client) for i, pair in enumerate(pairs)]
            served_launches = _launch_delta(before, _served_launches(client))
            row["served_launches"] = served_launches
            if (served_launches.get("crop_resize", {}).get("fused", 0) <= 0
                    or served_launches.get("flash_attention", {}).get("fused", 0) <= 0):
                raise AssertionError(f"served launches: {served_launches}")
            served = [p for ocr, _, _ in seq for p in ocr]
            row["sequential_ms"] = [ms for _, ms, _ in seq]
            golden = _against_golden(served, _without_heads(shipped["golden"]["pages"]),
                                     shipped["truth"]["pages"], (h, w))
            row["golden"] = golden
            if not golden["within_limits"]:
                raise AssertionError(f"served pages outside the golden's limits: {golden}")
            engine = get_known_ocr_engines("cuda", "default")["default"]
            pipe = ExtractPipeline(ocr_engine=engine, work_dir=os.path.join(work_dir, "local"),
                                   overlay_processor=_trained_overlay("cuda"), device="cuda")
            local = [p for i, pair in enumerate(pairs)
                     for p in pipe.execute(f"pair-{i}", "doc", list(pair))["ocr"]]
            row["in_process_word_diffs"] = _word_diffs(served, local)
            row["word_diff_limit"] = SERVE_WORD_DIFFS
            del engine, pipe

            # (c) all 8 in flight at once, a client thread each
            with ThreadPoolExecutor(SERVE_PAIRS) as pool:
                t0 = time.perf_counter()
                results = list(pool.map(request, pairs, range(SERVE_PAIRS), timeout=900))
                conc_wall = time.perf_counter() - t0
            conc_ms = [ms for _, ms, _ in results]
            row["concurrent"] = {
                "wall_s": conc_wall, "pages_per_s": n / conc_wall,
                "p50_ms": _percentile(conc_ms, 0.5), "p95_ms": _percentile(conc_ms, 0.95),
                "request_ms": conc_ms,
                "word_diffs_vs_sequential": sum(
                    _word_diffs(results[i][0], seq[i][0]) for i in range(SERVE_PAIRS)),
            }
            timings = [t for _, _, t in seq + results]
            row["json_encode_ms"] = statistics.median(t["encode_s"] for t in timings) * 1e3
            row["json_decode_ms"] = statistics.median(t["decode_s"] for t in timings) * 1e3
            row["sequential_p50_ms"] = _percentile(row["sequential_ms"], 0.5)
            row["sequential_pages_per_s"] = n / (sum(row["sequential_ms"]) / 1e3)

            # (d) no frames
            row["no_frames"] = envelope(client.post(
                "/document/extract", [Document(text="no pixels")], return_responses=True))
            client.close()
        finally:
            port = pod.port
            t0 = time.perf_counter()
            pod.close(timeout=SERVE_CLOSE_S)
            row["close_s"] = time.perf_counter() - t0
        # (e) the child is gone and its port free
        with socket.socket() as s:
            s.bind(("127.0.0.1", port))
        row["child_exitcode"] = pod.exitcode

    # (f) the NER executor in-process, through the worker's handler
    with open_zoo_json("golden_extract") as f:
        ner_labels = tuple(json.load(f)["settings"]["ner_labels"])
    indexer = LayoutDocumentIndexer(ner_labels, LayoutLMConfig.base(5), ner_tree, device="cuda")
    executor = NerExtractionExecutor(reading_order=True, indexer=indexer, device="cuda")
    golden_pages = shipped["golden"]["pages"]
    docs = [Document(id=f"g{i}", tags={"words": [wd["text"] for wd in g["words"]],
                                        "boxes": [wd["box"] for wd in g["words"]]})
            for i, g in enumerate(golden_pages)]
    handler = WorkerRequestHandler(executor=executor, name="ner")
    req = DataRequest.from_docs(docs, endpoint="/ner/extract", parameters={"ref_id": "smoke"})
    _reset_counts()
    t0 = time.perf_counter()
    resp = asyncio.run(handler.process_data([req]))
    torch.cuda.synchronize()
    ner_s = time.perf_counter() - t0
    ner_launches = _read_counts()
    if resp.is_error():
        raise AssertionError(f"NER request failed: {resp.status}")
    entities = resp.parameters["__results__"]["ner"]["entities"]
    direct = []
    for g in golden_pages:
        words = [wd["text"] for wd in g["words"]]
        boxes = [wd["box"] for wd in g["words"]]
        order = executor.text_layout.order(*reading_order_boxes(boxes, None))
        direct.append(PageInput([words[j] for j in order], [boxes[j] for j in order], None))
    want = _jsonify(indexer.index(direct))
    k2 = ner_launches["flash_attention"]
    row["ner"] = {"text_layout_trained": executor.text_layout.trained,
                  "entities": sum(len(p["entities"]) for p in entities),
                  "equal_to_direct": entities == want, "ms_per_page": ner_s / n * 1e3,
                  "launches": ner_launches}
    row["within_limits"] = (
        row["in_process_word_diffs"] <= SERVE_WORD_DIFFS
        and row["concurrent"]["word_diffs_vs_sequential"] <= SERVE_WORD_DIFFS
        and row["no_frames"] == {"status": "failed", "error": "no frames in request"}
        and row["close_s"] <= SERVE_CLOSE_S and row["child_exitcode"] is not None
        and row["ner"]["equal_to_direct"] and row["ner"]["entities"] > 0)
    emit(row)
    if not row["within_limits"]:
        raise AssertionError(f"serve checks failed: {row}")
    if executor.text_layout is None or k2.get("heads", 0) <= 0 or k2.get("reading_order", 0) <= 0:
        raise AssertionError(f"NER launches: {ner_launches}")
    launches = {name: {**{f"extract_{p}": v for p, v in served_launches.get(name, {}).items()},
                       **{f"ner_{p}": v for p, v in ner_launches[name].items() if p != "all"}}
                for name in ("crop_resize", "flash_attention")}
    return launches, served


GRPC_DEADLINE_S = 0.05  # a 2-page extract takes longer: the call must end DEADLINE_EXCEEDED
GRPC_SHARDS = 2
GRPC_FLOW_TURNS = ("cold",)  # the Flow's 8 in flight, once, on the workers' first requests


class _LoopThread:
    """An asyncio loop on a thread of its own, serving what is started on it."""

    def __init__(self):
        import asyncio
        import threading

        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()

    def call(self, coro, timeout: float = 600.0):
        import asyncio

        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def close(self) -> None:
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(30)
        if self.thread.is_alive():
            raise AssertionError("the server's loop thread did not stop")
        self.loop.close()


def _grpc_envelope(resp):
    """The executor's result of one served request: the one entry of
    ``__results__``, under the name of the worker that ran it (a replica
    of a sharded deployment is ``<name>/rep-<i>``)."""
    if resp.is_error():
        raise AssertionError(f"request failed: {resp.status}")
    results = resp.parameters["__results__"]
    if len(results) != 1 or [r.executor for r in resp.routes] != list(results):
        raise AssertionError(f"results of {list(results)}, routes {resp.routes}")
    return next(iter(results.values()))


def _grpc_pages(resp, n_pages: int, h: int, w: int):
    """The OCR pages of one served extract response (its envelope checked)."""
    env = _grpc_envelope(resp)
    if env.get("status") != "succeeded":
        raise AssertionError(f"extract answered {env}")
    _check_results(env["metadata"]["ocr"], n_pages, h, w)
    return env["metadata"]["ocr"]


def phase_grpc(shipped, http_pages):
    """The OCR executor served over the port's gRPC plane (HTTP/2 and the
    protobuf wire written on the standard library).

    (a) A ``GRPCServer`` on a loop thread of this process fronts
    ``WorkerRequestHandler(uses="marie_tpu_torch.executor.TextExtractionExecutor")``
    configured as the ``serve`` phase's worker; the client is the port's
    ``GRPCClient``.  Health ``Check`` is SERVING, ``dry_run`` true, ``_status``
    and ``endpoint_discovery`` answer.  The 16 shipped pages go as 8
    two-page ``/document/extract`` requests one at a time, in the JSON mode
    (``docs_bytes``) and again as ``DocListProto`` (``docs``): each
    ``"succeeded"``, the words of both within SERVE_WORD_DIFFS of the
    ``serve`` phase's HTTP answers, and K1 and K2 launched on ``"fused"``
    in the JSON pass (counts set to 0 just before it, read just after).
    Then the 8 requests at once on one channel, and once more through
    ``astream`` (``Call``, order kept).  Request ms (first, p50, p95),
    pages/s, ``to_bytes`` / ``from_bytes`` ms of one request in each mode.
    (b) ``Flow().add(name="extract", uses=<as above>, shards=GRPC_SHARDS,
    polling="any")`` starts gateway -> head -> GRPC_SHARDS worker pods on
    the one card: startup s; the 8 requests in flight all answered, by
    both workers (round robin), words equal to (a)'s; a request with no
    frames gets the JAX envelope; a call past its deadline
    DEADLINE_EXCEEDED; every child exits within SERVE_CLOSE_S of
    ``close()`` and its port is free again.  Returns (a)'s launches."""
    import asyncio
    import tempfile

    import torch

    from marie_tpu_torch.clients import GRPCClient
    from marie_tpu_torch.orchestrate.flow import Flow
    from marie_tpu_torch.serve.networking.grpc_wire import RpcError, StatusCode
    from marie_tpu_torch.serve.runtimes.servers import GRPCServer
    from marie_tpu_torch.serve.runtimes.worker.request_handling import WorkerRequestHandler
    from marie_tpu_torch.types import Document
    from marie_tpu_torch.types.request import DataRequest

    pages = list(shipped["pages"])
    n, (h, w) = len(pages), pages[0].shape
    pairs = [pages[2 * i:2 * i + 2] for i in range(SERVE_PAIRS)]
    name = "extract"
    uses = "marie_tpu_torch.executor.TextExtractionExecutor"
    row = {"phase": "grpc", "pages": n, "requests": SERVE_PAIRS}

    def docs_of(i, pair):
        return [Document(id=f"p{i}-{k}", tensor=p) for k, p in enumerate(pair)]

    async def one(client, i, pair, timeout=None):
        t = time.perf_counter()
        resp = await client.apost("/document/extract", docs_of(i, pair),
                                  parameters={"ref_id": f"pair-{i}", "job_id": f"job-{i}"},
                                  timeout=timeout, return_responses=True)
        return resp, (time.perf_counter() - t) * 1e3

    def stats(ms, wall_s):
        return {"first_ms": ms[0], "p50_ms": _percentile(ms, 0.5), "p95_ms": _percentile(ms, 0.95),
                "pages_per_s": n / wall_s, "wall_s": wall_s, "request_ms": ms}

    with tempfile.TemporaryDirectory() as work_dir:
        uses_with = {"ocr_engine": "default", "device": "cuda",
                     "work_dir": os.path.join(work_dir, "grpc")}
        # (a) in-process server
        loop = _LoopThread()
        server = GRPCServer(WorkerRequestHandler(uses=uses, uses_with=uses_with, name=name))
        loop.call(server.setup_server())
        try:
            async def part_a():
                out = {}
                client = GRPCClient(port=server.port)
                out["health"] = await client.ahealth()
                out["dry_run"] = await client.adry_run()
                out["status_keys"] = sorted(await client.ainfo())
                raw = await client._channel().unary_unary(
                    "/jina.JinaDiscoverEndpointsRPC/endpoint_discovery", b"", timeout=30)
                from marie_tpu_torch.proto import messages

                out["endpoints"] = messages.decode("jina.EndpointsProto", raw).get("endpoints", [])
                for mode in ("docs_bytes", "docs"):
                    client.wire_mode = mode
                    if mode == "docs_bytes":
                        _reset_counts()
                    t0 = time.perf_counter()
                    seq = [await one(client, i, pair) for i, pair in enumerate(pairs)]
                    wall = time.perf_counter() - t0
                    if mode == "docs_bytes":
                        torch.cuda.synchronize()
                        out["launches"] = _read_counts()
                    out[mode] = (seq, wall)
                client.wire_mode = "docs_bytes"
                t0 = time.perf_counter()
                conc = await asyncio.gather(*(one(client, i, pair)
                                              for i, pair in enumerate(pairs)))
                out["concurrent"] = (conc, time.perf_counter() - t0)
                reqs = [DataRequest.from_docs(docs_of(i, pair), endpoint="/document/extract",
                                              parameters={"ref_id": f"pair-{i}"})
                        for i, pair in enumerate(pairs)]
                t0 = time.perf_counter()
                streamed = [r async for r in client.astream(iter(reqs), timeout=900)]
                out["stream"] = (streamed, time.perf_counter() - t0,
                                 [r.request_id for r in reqs])
                await client.aclose()
                return out

            a = asyncio.run(part_a())
        finally:
            loop.call(server.shutdown())
            loop.close()
        if a["health"] != 1 or a["dry_run"] is not True or "device" not in a["status_keys"] \
                or a["endpoints"] != ["/document/extract", "/document/status"]:
            raise AssertionError(f"gRPC services: {a['health']} {a['dry_run']} "
                                 f"{a['status_keys']} {a['endpoints']}")
        launches = a["launches"]
        row["launches"] = launches
        if (launches["crop_resize"].get("fused", 0) <= 0
                or launches["flash_attention"].get("fused", 0) <= 0):
            raise AssertionError(f"gRPC-served launches: {launches}")
        served = {}
        for mode in ("docs_bytes", "docs"):
            seq, wall = a[mode]
            got = [p for (resp, _), pair in zip(seq, pairs)
                   for p in _grpc_pages(resp, len(pair), h, w)]
            served[mode] = got
            if seq[0][0].wire_mode != mode:
                raise AssertionError(f"answered in {seq[0][0].wire_mode} to a {mode} request")
            row[mode] = {**stats([ms for _, ms in seq], wall),
                         "word_diffs_vs_http": _word_diffs(got, http_pages)}
        conc, conc_wall = a["concurrent"]
        conc_pages = [p for (resp, _), pair in zip(conc, pairs)
                      for p in _grpc_pages(resp, len(pair), h, w)]
        row["concurrent"] = {**stats([ms for _, ms in conc], conc_wall),
                             "word_diffs_vs_sequential": _word_diffs(conc_pages,
                                                                     served["docs_bytes"])}
        streamed, stream_wall, ids = a["stream"]
        stream_pages = [p for resp, pair in zip(streamed, pairs)
                        for p in _grpc_pages(resp, len(pair), h, w)]
        row["stream"] = {"wall_s": stream_wall, "pages_per_s": n / stream_wall,
                         "in_order": [r.request_id for r in streamed] == ids,
                         "word_diffs_vs_sequential": _word_diffs(stream_pages,
                                                                 served["docs_bytes"])}
        # the wire codec's cost on one 2-page request, each mode
        row["codec_ms"] = {}
        for mode in ("docs_bytes", "docs"):
            req = DataRequest.from_docs(docs_of(0, pairs[0]), endpoint="/document/extract")
            req.wire_mode = mode
            t0 = time.perf_counter()
            raw = req.to_bytes()
            t1 = time.perf_counter()
            len(DataRequest.from_bytes(raw).docs)
            t2 = time.perf_counter()
            resp = a[mode][0][0][0]
            t3 = time.perf_counter()
            raw_resp = resp.copy().to_bytes()
            t4 = time.perf_counter()
            DataRequest.from_bytes(raw_resp).parameters
            t5 = time.perf_counter()
            row["codec_ms"][mode] = {
                "request_bytes": len(raw), "request_to_bytes_ms": (t1 - t0) * 1e3,
                "request_from_bytes_ms": (t2 - t1) * 1e3, "response_bytes": len(raw_resp),
                "response_to_bytes_ms": (t4 - t3) * 1e3,
                "response_from_bytes_ms": (t5 - t4) * 1e3}

        # (b) gateway -> head -> workers, in pods
        flow = Flow().add(name=name, uses=uses, uses_with={**uses_with, "work_dir": os.path.join(
            work_dir, "flow")}, shards=GRPC_SHARDS, polling="any")
        t0 = time.perf_counter()
        flow.start()
        row["flow_startup_s"] = time.perf_counter() - t0
        try:
            pods = flow.pods
            ports = [p.port for p in pods]

            async def part_b():
                client = GRPCClient(port=flow.port_gateway)
                out = {"dry_run": await client.adry_run(timeout=60)}
                for turn in GRPC_FLOW_TURNS:
                    t0 = time.perf_counter()
                    out[turn] = await asyncio.gather(*(one(client, i, pair)
                                                       for i, pair in enumerate(pairs)))
                    out[f"{turn}_wall"] = time.perf_counter() - t0
                out["no_frames"] = _grpc_envelope(await client.apost(
                    "/document/extract", [Document(text="no pixels")], return_responses=True))
                try:
                    await one(client, 0, pairs[0], timeout=GRPC_DEADLINE_S)
                    out["deadline"] = "answered"
                except RpcError as ex:
                    out["deadline"] = ex.code().name
                await client.aclose()
                return out

            b = asyncio.run(part_b())
        finally:
            t0 = time.perf_counter()
            flow.close()
            row["flow_close_s"] = time.perf_counter() - t0
        flow_pages = {turn: [p for (resp, _), pair in zip(b[turn], pairs)
                             for p in _grpc_pages(resp, len(pair), h, w)]
                      for turn in GRPC_FLOW_TURNS}
        workers = sorted({r.executor for turn in GRPC_FLOW_TURNS for resp, _ in b[turn]
                          for r in resp.routes})
        free = _ports_free(ports)
        row["flow"] = {
            "pods": len(pods), "dry_run": b["dry_run"], "workers": workers,
            **{turn: stats([ms for _, ms in b[turn]], b[f"{turn}_wall"])
               for turn in GRPC_FLOW_TURNS},
            "word_diffs_vs_in_process": sum(_word_diffs(flow_pages[turn], served["docs_bytes"])
                                            for turn in GRPC_FLOW_TURNS),
            "no_frames": b["no_frames"], "deadline": b["deadline"],
            "exitcodes": [p.exitcode for p in pods], "ports_free": free}
    row["within_limits"] = (
        row["docs_bytes"]["word_diffs_vs_http"] <= SERVE_WORD_DIFFS
        and row["docs"]["word_diffs_vs_http"] <= SERVE_WORD_DIFFS
        and row["concurrent"]["word_diffs_vs_sequential"] <= SERVE_WORD_DIFFS
        and row["stream"]["in_order"]
        and row["stream"]["word_diffs_vs_sequential"] <= SERVE_WORD_DIFFS
        and row["flow"]["dry_run"] is True
        and workers == [f"{name}/rep-{i}" for i in range(GRPC_SHARDS)]
        and row["flow"]["word_diffs_vs_in_process"] <= SERVE_WORD_DIFFS
        and row["flow"]["no_frames"] == {"status": "failed", "error": "no frames in request"}
        and row["flow"]["deadline"] == StatusCode.DEADLINE_EXCEEDED.name
        and row["flow_close_s"] <= SERVE_CLOSE_S
        and all(c is not None for c in row["flow"]["exitcodes"]) and all(free))
    emit(row)
    if not row["within_limits"]:
        raise AssertionError(f"grpc checks failed: {row}")
    return launches, row["docs_bytes"]["p50_ms"]


SERVER_READY_S = 300.0  # a boot: two engines, the base indexer and their warm-ups
SERVER_JOB_S = 90.0  # a submitted job reaches a terminal state (the scheduler polls)
WARMUP_ENV = "MARIE_PROGRAM_ZOO_ENABLE"
SERVER_DEVICE = "cuda"
SERVER_COLD_PAIRS = 2  # the cold boot's requests: the first on cold workers, and one after it


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _descendants(pid: int) -> list:
    """The pids of ``pid``'s children and their children (from /proc)."""
    parents = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        parents[int(entry)] = int(stat.rsplit(")", 1)[1].split()[1])
    out, frontier = [], [pid]
    while frontier:
        p = frontier.pop()
        kids = [c for c, pp in parents.items() if pp == p]
        out += kids
        frontier += kids
    return out


def _rest(port: int, method: str, path: str, payload=None, timeout: float = 600.0):
    """(status, JSON answer) of one call to the control plane."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method=method, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            body = r.read()
            status = r.status
    except urllib.error.HTTPError as ex:
        body, status = ex.read(), ex.code
    try:
        return status, json.loads(body)
    except ValueError:
        return status, body.decode(errors="replace")


def _metrics_launches(port: int) -> dict:
    """{"requests": {kernel: {path: n}}, "warmup": {...}, "warmup_s", "build_s"}
    from the control plane's ``/metrics`` (the Flow's workers summed)."""
    import re

    status, text = _rest(port, "GET", "/metrics")
    if status != 200:
        raise AssertionError(f"/metrics answered {status}")
    out = {"requests": {}, "warmup": {}, "warmup_s": 0.0, "build_s": None}
    for name, key in (("marie_kernel_launches_total", "requests"),
                      ("marie_warmup_launches_total", "warmup")):
        for kernel, path, n in re.findall(
                rf'^{name}\{{kernel="(\w+)",path="(\w+)"\}} (\d+)$', text, re.M):
            out[key].setdefault(kernel, {})[path] = int(n)
    m = re.search(r"^marie_warmup_seconds (\S+)$", text, re.M)
    out["warmup_s"] = float(m.group(1)) if m else 0.0
    m = re.search(r"^marie_kernel_build_seconds_sum (\S+)$", text, re.M)
    out["build_s"] = float(m.group(1)) if m else None
    return out


def _boot(repo, work_dir, label, warmup: bool, pairs, ner_page, http_pages, h, w):
    """One boot of ``python -m marie_tpu_torch.cli server --start --uses <yml>``
    in a child process, driven over its REST control plane, then stopped."""
    import base64
    import signal
    import subprocess

    from marie_tpu_torch.utils.image_io import write_png, write_tiff

    boot_dir = os.path.join(work_dir, label)
    os.makedirs(boot_dir)
    gateway, rest = _free_port(), _free_port()
    yml = os.path.join(boot_dir, "server.yml")
    with open(yml, "w") as f:
        f.write(f"""jtype: Flow
with:
  port: {gateway}
  protocol: grpc
executors:
  - name: extract
    uses:
      jtype: marie_tpu_torch.executor.TextExtractionExecutor
      with:
        ocr_engine: default
        device: {SERVER_DEVICE}
        work_dir: {os.path.join(boot_dir, "served")}
  - name: ner
    uses:
      jtype: marie_tpu_torch.executor.NerExtractionExecutor
      with:
        ocr_engine: default
        reading_order: true
        device: {SERVER_DEVICE}
""")
    docs = []
    for i, pair in enumerate(pairs):  # each request names a 2-page TIFF by uri
        path = os.path.join(boot_dir, f"pair-{i}.tif")
        write_tiff(path, list(pair))
        docs.append(path)
    buf = __import__("io").BytesIO()
    write_png(buf, ner_page)
    ner_body = {"data": base64.b64encode(buf.getvalue()).decode(), "doc_id": "ner-0"}
    env = dict(os.environ, TMPDIR=boot_dir)
    env[WARMUP_ENV] = "1" if warmup else "0"
    log_path = os.path.join(boot_dir, "server.log")
    row = {"boot": label, "warmup": warmup}
    with open(log_path, "wb") as log:
        t0 = time.perf_counter()
        child = subprocess.Popen(
            [sys.executable, "-m", "marie_tpu_torch.cli", "server", "--start", "--uses", yml,
             "--rest-port", str(rest), "--device", SERVER_DEVICE], cwd=repo, env=env, stdout=log, stderr=subprocess.STDOUT)
        try:
            while True:
                if child.poll() is not None:
                    raise AssertionError(f"server exited {child.returncode} during startup")
                if time.perf_counter() - t0 > SERVER_READY_S:
                    raise AssertionError(f"server not ready within {SERVER_READY_S} s")
                try:
                    if _rest(rest, "GET", "/health/status", timeout=5)[0] == 200:
                        break
                except OSError:
                    pass
                time.sleep(0.2)
            row["startup_s"] = time.perf_counter() - t0
            # a job first: the scheduler's poll picks it up during the requests
            status, sub = _rest(rest, "POST", "/api/jobs/submit",
                                {"entrypoint": "/document/status", "metadata": {}})
            if status != 200 or sub.get("status") != "ok":
                raise AssertionError(f"job submit: {status} {sub}")
            job_id = sub["jobid"]
            before = _metrics_launches(rest)
            row["build_s"] = before["build_s"]
            row["warmup_s"] = before["warmup_s"]
            row["warmup_launches"] = before["warmup"]
            pages, ms = [], []
            for i, path in enumerate(docs):
                t = time.perf_counter()
                status, body = _rest(rest, "POST", "/api/document/extract", {"uri": path})
                ms.append((time.perf_counter() - t) * 1e3)
                if status != 200 or body.get("status") != "succeeded":
                    raise AssertionError(f"extract {i}: {status} {str(body)[:500]}")
                _check_results(body["metadata"]["ocr"], 2, h, w)
                pages += body["metadata"]["ocr"]
            mid = _metrics_launches(rest)
            row["launches"] = _launch_delta(before["requests"], mid["requests"])
            t = time.perf_counter()
            status, ner = _rest(rest, "POST", "/api/ner/extract", ner_body)
            row["ner_ms"] = (time.perf_counter() - t) * 1e3
            if status != 200 or ner.get("status") != "succeeded" \
                    or len(ner.get("entities", ())) != 1:
                raise AssertionError(f"ner: {status} {str(ner)[:500]}")
            row["ner_entities"] = len(ner["entities"][0]["entities"])
            row["ner_launches"] = _launch_delta(mid["requests"],
                                                _metrics_launches(rest)["requests"])
            row["first_request_ms"] = ms[0]
            row["rest_p50_ms"] = _percentile(ms[1:], 0.5)
            row["request_ms"] = ms
            row["word_diffs_vs_serve"] = _word_diffs(pages, http_pages) + abs(
                len(pages) - len(http_pages))
            state, t = None, time.perf_counter()
            while time.perf_counter() - t < SERVER_JOB_S:
                status, info = _rest(rest, "GET", f"/api/jobs/{job_id}")
                state = info.get("state") if status == 200 else None
                if state in ("completed", "failed", "cancelled", "expired"):
                    break
                time.sleep(0.25)
            row["job_state"] = state
            row["job_wait_s"] = time.perf_counter() - t0 - row["startup_s"]
            status, nodes = _rest(rest, "GET", "/api/nodes")
            ports = [gateway, rest] + [int(a.rsplit(":", 1)[1])
                                       for addrs in nodes["deployments"].values()
                                       for a in addrs]
        finally:
            kids = _descendants(child.pid)
            t = time.perf_counter()
            if child.poll() is None:
                child.send_signal(signal.SIGTERM)
            try:
                child.wait(timeout=SERVE_CLOSE_S)
            except subprocess.TimeoutExpired:
                child.kill()
                child.wait()
            deadline = t + SERVE_CLOSE_S
            while time.perf_counter() < deadline and any(
                    os.path.exists(f"/proc/{k}") for k in kids):
                time.sleep(0.05)
            row["stop_s"] = time.perf_counter() - t
            left = [k for k in kids if os.path.exists(f"/proc/{k}")]
            for k in left:  # stop what outlived the limit, then fail below
                try:
                    os.kill(k, signal.SIGKILL)
                except OSError:
                    pass
    row["exitcode"] = child.returncode
    row["children"] = len(kids)
    row["children_left"] = len(left)
    row["ports_free"] = _ports_free(ports)
    with open(log_path, "rb") as f:
        row["log_tail"] = f.read()[-1500:].decode(errors="replace") if (
            row["exitcode"] != 0 or left) else ""
    return row


def phase_server(shipped, http_pages):
    """The server shell booted from YAML on the card, through the CLI a user
    runs: ``python -m marie_tpu_torch.cli server --start --uses <yml>`` in a
    child process, with a Flow of ``TextExtractionExecutor`` (``ocr_engine:
    default``) and ``NerExtractionExecutor`` (its own ``default`` engine,
    reading order on).  Booted twice in turns: with the warm-up (on by
    default on the card) and with ``MARIE_PROGRAM_ZOO_ENABLE=0``, the cold
    start.  Each boot: startup s (to ``/health/status`` 200), the kernels'
    build s and the warm-up's s and launches (``/metrics``: none on the
    cold boot); one job through ``/api/jobs/submit`` reaches a terminal
    state; two-page ``POST /api/document/extract`` requests (each a
    2-page TIFF by ``uri``), the 16 shipped pages as 8 on the warm boot
    and the first SERVER_COLD_PAIRS pairs on the cold one: first-request
    ms and the p50 of the rest, the words equal to the ``serve`` phase's
    HTTP answers of those pages (0 differences), K1 once and K2 6 times a
    request on ``"fused"`` in the workers (the warm-up's apart); one
    ``/api/ner/extract`` of a PNG page: K2 on ``"heads"`` and
    ``"reading_order"``; SIGTERM stops the child and every process under
    it within SERVE_CLOSE_S, with every port free.  Returns the warm
    boot's launches."""
    import tempfile

    repo = os.path.dirname(os.path.abspath(__file__))
    pages = list(shipped["pages"])
    n, (h, w) = len(pages), pages[0].shape
    pairs = [pages[2 * i:2 * i + 2] for i in range(SERVE_PAIRS)]
    row = {"phase": "server", "pages": n, "requests": SERVE_PAIRS, "boots": []}
    with tempfile.TemporaryDirectory() as work_dir:
        for label, warmup, k in (("warm", True, SERVE_PAIRS), ("cold", False, SERVER_COLD_PAIRS)):
            row["boots"].append(_boot(repo, work_dir, label, warmup, pairs[:k], pages[0],
                                      http_pages[:2 * k], h, w))
    ok = True
    for b in row["boots"]:
        fused = {k: b["launches"].get(k, {}).get("fused", 0)
                 for k in ("crop_resize", "flash_attention")}
        requests = len(b["request_ms"])
        ner = b["ner_launches"].get("flash_attention", {})
        b["within_limits"] = (
            b["word_diffs_vs_serve"] <= SERVE_WORD_DIFFS
            and fused == {"crop_resize": requests, "flash_attention": 6 * requests}
            and ner.get("heads", 0) > 0 and ner.get("reading_order", 0) > 0
            and b["job_state"] == "completed" and b["exitcode"] == 0
            and b["stop_s"] <= SERVE_CLOSE_S and b["children"] >= 3
            and b["children_left"] == 0 and all(b["ports_free"])
            and (bool(b["warmup_launches"]) == b["warmup"]))
        ok = ok and b["within_limits"]
    row["within_limits"] = ok
    emit(row)
    if not ok:
        raise AssertionError(f"server checks failed: {row}")
    warm = row["boots"][0]
    return {name: {f"extract_{p}": v for p, v in warm["launches"].get(name, {}).items()}
            for name in ("crop_resize", "flash_attention")}


GATEWAY_PROTOCOLS = ("grpc", "http", "websocket")
GATEWAY_DEREGISTER_S = 2.0  # a closed pod's key leaves the registry within this
GATEWAY_HTTP_GRPC_PAIRS = 2  # pairs 0 and 1 over HTTP and over gRPC


def _json_pages(body, n_pages: int, h: int, w: int):
    """The OCR pages of one ``/post``-shaped answer (the gateway's over
    HTTP or WebSocket, a cloud app's): its one ``__results__`` entry."""
    if body["header"]["status"]["code"] != 0:
        raise AssertionError(f"request failed: {body['header']['status']}")
    results = body["parameters"]["__results__"]
    if len(results) != 1:
        raise AssertionError(f"results of {list(results)}")
    env = next(iter(results.values()))
    if env.get("status") != "succeeded":
        raise AssertionError(f"extract answered {env}")
    _check_results(env["metadata"]["ocr"], n_pages, h, w)
    return env["metadata"]["ocr"]


def _ports_free(ports) -> list:
    import socket

    free = []
    for port in ports:
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
                free.append(True)
            except OSError:
                free.append(False)
    return free


def phase_gateway(shipped, http_pages):
    """One gateway on every protocol, its workers from discovery, traced.

    (a) A ``DiscoveryServer`` on a loop thread of this process; a worker
    pod of ``TextExtractionExecutor`` configured as the ``serve`` phase's,
    with ``discovery_address`` and ``port_monitoring``; a gateway on the
    loop thread: ``AsyncNewLoopRuntime`` over a ``GatewayRequestHandler``
    with no static graph, ``protocols`` gRPC, HTTP and WebSocket,
    ``port_monitoring`` and ``cors``, its topology from
    ``start_discovery`` only.  Gates: the worker's key under ``gateway/``
    with its address, the gateway's topology names it; the pod's start s
    and the time to its registration.  (b) The 16 shipped pages as the 8
    two-page requests in flight on one socket through ``WebSocketClient``:
    each answer matched back by ``requestId`` (its docs are its request's),
    the words equal to the ``serve`` phase's HTTP answers (0 differences),
    K1 8 and K2 48 on ``"fused"`` from the worker's monitoring port
    (``marie_kernel_launches_total``, the warm-up's apart).  (c) Pairs 0
    and 1 over HTTP and over gRPC through the same gateway: the words
    equal (b)'s, the counts at K1 12 and K2 72; an ``OPTIONS`` preflight
    204 with the allow-all headers.  (d) One gRPC request inside a span:
    the client's trace id on the gateway's ``rpc/`` span and on the
    ``traceparent`` the gateway's pool sent the worker (read off its
    channel), under that span.  The worker's launches of (b) to (d) are
    this path's.  (e) A ``SagemakerHTTPServer`` in this
    process over a second handler of the executor on the card: ``GET
    /ping`` 200 ``{}``, pair 0 as a JSON ``/invocations`` body gets (b)'s
    words.  (f) The gateway closed, then the worker pod: its key gone within
    GATEWAY_DEREGISTER_S of SIGTERM (it deregisters), no lease expired in
    the phase (the keepalive was not starved), the child gone within
    SERVE_CLOSE_S and every port of the phase free.  Request ms (first,
    p50, p95) and pages/s of each protocol.  Returns the launches:
    ``{kernel: {"fused": the worker's, "cloud_fused": this process's}}``."""
    import asyncio
    import http.client
    import tempfile

    import torch

    from marie_tpu_torch.clients import GRPCClient, HTTPClient, WebSocketClient
    from marie_tpu_torch.helper import random_port
    from marie_tpu_torch.orchestrate.pods import Pod
    from marie_tpu_torch.serve.discovery import DiscoveryClient, DiscoveryServer
    from marie_tpu_torch.serve.instrumentation import tracing
    from marie_tpu_torch.serve.runtimes.asyncio_runtime import AsyncNewLoopRuntime
    from marie_tpu_torch.serve.runtimes.gateway.request_handling import GatewayRequestHandler
    from marie_tpu_torch.serve.runtimes.servers import SagemakerHTTPServer
    from marie_tpu_torch.serve.runtimes.worker.request_handling import WorkerRequestHandler
    from marie_tpu_torch.types import Document, DocumentArray

    t_phase = time.perf_counter()
    pages = list(shipped["pages"])
    n, (h, w) = len(pages), pages[0].shape
    pairs = [pages[2 * i:2 * i + 2] for i in range(SERVE_PAIRS)]
    name = "extract"
    uses = "marie_tpu_torch.executor.TextExtractionExecutor"
    key = f"gateway/{name}/{name}"
    row = {"phase": "gateway", "pages": n, "requests": SERVE_PAIRS,
           "protocols": list(GATEWAY_PROTOCOLS)}

    def docs_of(i, pair):
        return [Document(id=f"p{i}-{k}", tensor=p) for k, p in enumerate(pair)]

    def stats(ms, wall_s, n_pages):
        return {"first_ms": ms[0], "p50_ms": _percentile(ms, 0.5),
                "p95_ms": _percentile(ms, 0.95), "pages_per_s": n_pages / wall_s,
                "wall_s": wall_s, "request_ms": ms}

    loop = _LoopThread()
    events = []  # (seconds since the phase began, watch event)
    disc = DiscoveryServer(host="127.0.0.1")
    loop.call(disc.start())
    watcher = DiscoveryClient(disc.address)
    loop.call(watcher.watch("gateway/", lambda e: events.append(
        (time.perf_counter() - t_phase, e))))
    gw_ports = [random_port() for _ in GATEWAY_PROTOCOLS]
    worker_mport, gw_mport, cloud_port = random_port(), random_port(), random_port()
    handler = GatewayRequestHandler({"start-gateway": []}, {}, name="gateway")
    runtime = AsyncNewLoopRuntime(handler, protocols=list(GATEWAY_PROTOCOLS), ports=gw_ports,
                                  port_monitoring=gw_mport, cors=True, name="gateway")
    serving = asyncio.run_coroutine_threadsafe(runtime._serve(), loop.loop)
    cloud = pod = None
    ports = [disc.port, cloud_port, worker_mport, gw_mport] + gw_ports
    with tempfile.TemporaryDirectory() as work_dir:
        uses_with = {"ocr_engine": "default", "device": SERVER_DEVICE,
                     "work_dir": os.path.join(work_dir, "gateway")}
        try:
            # (a) the topology from discovery
            pod = Pod("worker", uses=uses, uses_with=uses_with, name=name, deployment=name,
                      discovery_address=disc.address, port_monitoring=worker_mport)
            t_launch = time.perf_counter()
            pod.launch()
            deadline = time.perf_counter() + 30
            while runtime._monitoring_server is None:  # set once every server is up
                if time.perf_counter() > deadline or serving.done():
                    raise AssertionError(f"the gateway did not start: {serving}")
                time.sleep(0.05)
            loop.call(handler.start_discovery(disc.address))
            pod.wait_ready()
            row["pod_start_s"] = time.perf_counter() - t_launch
            pool = handler.streamer.connection_pool
            deadline = time.perf_counter() + 10
            while pool.addresses(name) != [pod.address] and time.perf_counter() < deadline:
                time.sleep(0.05)
            # the watch's put event, from the launch (the key goes in once the
            # worker has warmed up and bound its server, just before readiness)
            registered = [t for t, e in events if e["op"] == "put" and e["key"] == key]
            row["register_s"] = registered[0] - (t_launch - t_phase) if registered else None
            items = loop.call(watcher.get_prefix("gateway/"))
            row["registry"] = items
            row["topology"] = {d: pool.addresses(d) for d in pool.deployments()}
            if items != {key: json.dumps({"address": pod.address})} \
                    or row["topology"] != {name: [pod.address]}:
                raise AssertionError(f"discovery: registry {items}, topology {row['topology']}")

            # (b) the 8 requests in flight on one socket
            monitor = HTTPClient(port=worker_mport)
            before = _served_launches(monitor)
            replies = []

            async def over_websocket():
                client = WebSocketClient(port=gw_ports[2])
                docs = [d for i, pair in enumerate(pairs) for d in docs_of(i, pair)]
                t0 = time.perf_counter()
                bodies = await client.apost(
                    "/document/extract", docs, request_size=2, return_responses=True,
                    timeout=900, on_done=lambda b: replies.append(time.perf_counter() - t0))
                return bodies, time.perf_counter() - t0

            bodies, ws_wall = asyncio.run(over_websocket())
            after_b = _served_launches(monitor)
            ws_pages = []
            for i, (body, pair) in enumerate(zip(bodies, pairs)):
                if [d["id"] for d in body["data"]] != [f"p{i}-{k}" for k in range(len(pair))]:
                    raise AssertionError(f"reply {i} is another request's: "
                                         f"{[d['id'] for d in body['data']]}")
                ws_pages.append(_json_pages(body, len(pair), h, w))
            ws_flat = [p for got in ws_pages for p in got]
            row["websocket"] = {**stats([t * 1e3 for t in replies], ws_wall, n),
                                "word_diffs_vs_serve": _word_diffs(ws_flat, http_pages)
                                + abs(len(ws_flat) - len(http_pages))}
            row["launches_b"] = _launch_delta(before, after_b)

            # (c) pairs 0 and 1 over HTTP and over gRPC, through the same gateway
            first = list(enumerate(pairs[:GATEWAY_HTTP_GRPC_PAIRS]))
            http_client = HTTPClient(port=gw_ports[1])
            t0 = time.perf_counter()
            http_got, http_ms = [], []
            for i, pair in first:
                t = time.perf_counter()
                http_got.append(_json_pages(http_client.post(
                    "/document/extract", docs_of(i, pair), return_responses=True, timeout=900),
                    len(pair), h, w))
                http_ms.append((time.perf_counter() - t) * 1e3)
            http_wall = time.perf_counter() - t0

            async def over_grpc():
                client = GRPCClient(port=gw_ports[0])
                got, ms = [], []
                t0 = time.perf_counter()
                for i, pair in first:
                    t = time.perf_counter()
                    got.append(_grpc_pages(await client.apost(
                        "/document/extract", docs_of(i, pair), return_responses=True,
                        timeout=900), len(pair), h, w))
                    ms.append((time.perf_counter() - t) * 1e3)
                wall = time.perf_counter() - t0
                await client.aclose()
                return got, ms, wall

            grpc_got, grpc_ms, grpc_wall = asyncio.run(over_grpc())
            want = [p for got in ws_pages[:GATEWAY_HTTP_GRPC_PAIRS] for p in got]
            for proto, got, ms, wall in (("http", http_got, http_ms, http_wall),
                                         ("grpc", grpc_got, grpc_ms, grpc_wall)):
                flat = [p for g in got for p in g]
                row[proto] = {**stats(ms, wall, len(flat)),
                              "word_diffs_vs_websocket": _word_diffs(flat, want)
                              + abs(len(flat) - len(want))}
            after_c = _served_launches(monitor)
            row["launches_c"] = _launch_delta(before, after_c)
            conn = http.client.HTTPConnection("127.0.0.1", gw_ports[1], timeout=30)
            conn.request("OPTIONS", "/post", headers={"Origin": "http://example"})
            r = conn.getresponse()
            r.read()
            row["preflight"] = {"status": r.status, **{k: r.getheader(k) for k in (
                "Access-Control-Allow-Origin", "Access-Control-Allow-Methods",
                "Access-Control-Allow-Headers")}}
            conn.close()
            http_client.close()

            # (d) one traced gRPC request
            replica = pool._deployments[name].replicas[0]
            channel = replica.get_channel()
            sent = []
            plain_call = channel.unary_unary

            async def recording(path, request, timeout=None, metadata=None):
                sent.append(dict(metadata or ()))
                return await plain_call(path, request, timeout=timeout, metadata=metadata)

            channel.unary_unary = recording
            tracing.collector.drain()
            try:
                async def traced():
                    client = GRPCClient(port=gw_ports[0])
                    with tracing.start_span("smoke/gateway") as span:
                        resp = await client.apost(
                            "/document/extract", docs_of(0, pairs[0]), return_responses=True,
                            timeout=900)
                    await client.aclose()
                    return span, resp

                root, resp = asyncio.run(traced())
            finally:
                del channel.unary_unary
            _grpc_pages(resp, 2, h, w)
            spans = {s.name: s for s in tracing.collector.drain()}
            client_span, rpc_span = spans.get("client/post"), spans.get("rpc/handler")
            pool_tp = [m.get("traceparent") for m in sent]
            row["trace"] = {
                "trace_id": root.trace_id, "spans": sorted(spans),
                "client": client_span is not None and client_span.trace_id == root.trace_id,
                "gateway_rpc": rpc_span is not None and rpc_span.trace_id == root.trace_id
                and rpc_span.parent_span_id == client_span.span_id,
                "pool_traceparent": pool_tp,
                "pool": rpc_span is not None
                and pool_tp == [f"00-{root.trace_id}-{rpc_span.span_id}-01"]}
            row["launches"] = _launch_delta(before, _served_launches(monitor))
            monitor.close()

            # (e) the cloud app over a second handler of the executor, in this process
            cloud = SagemakerHTTPServer(WorkerRequestHandler(
                uses=uses, uses_with={**uses_with, "work_dir": os.path.join(work_dir, "cloud")},
                name=name), port=cloud_port)
            loop.call(cloud.setup_server())
            ping = _rest(cloud_port, "GET", "/ping")
            payload = {"data": DocumentArray(docs_of(0, pairs[0])).to_dict(),
                       "execEndpoint": "/document/extract", "parameters": {}}
            _reset_counts()
            t = time.perf_counter()
            status, body = _rest(cloud_port, "POST", "/invocations", payload)
            cloud_ms = (time.perf_counter() - t) * 1e3
            torch.cuda.synchronize()
            cloud_launches = _read_counts()
            if status != 200:
                raise AssertionError(f"/invocations answered {status}: {str(body)[:500]}")
            cloud_pages = _json_pages(body, 2, h, w)
            row["cloud"] = {"ping": list(ping), "invocations_status": status,
                            "first_ms": cloud_ms, "launches": cloud_launches,
                            "word_diffs_vs_websocket": _word_diffs(cloud_pages, ws_pages[0])}
        finally:
            # the gateway first, as a Flow closes (its channels to the worker
            # close from its side: no TIME_WAIT on the worker's port)
            loop.call(handler.stop_discovery())
            loop.loop.call_soon_threadsafe(runtime._cancel_event.set)
            serving.result(60)
            # (f) the worker closed: it deregisters, and the child ends
            if pod is not None:
                t = time.perf_counter()
                pod.terminate()
                gone = None
                while time.perf_counter() - t < SERVE_CLOSE_S:
                    if key not in loop.call(watcher.get_prefix("gateway/")):
                        gone = time.perf_counter() - t
                        break
                    time.sleep(0.05)
                while pod.is_alive() and time.perf_counter() - t < SERVE_CLOSE_S:
                    time.sleep(0.05)  # the graceful stop runs on (one SIGTERM)
                pod.close(timeout=SERVE_CLOSE_S)
                row["deregister_s"] = gone
                row["pod_close_s"] = time.perf_counter() - t
                row["pod_exitcode"] = pod.exitcode
                ports += [pod.port]
            if cloud is not None:
                loop.call(cloud.shutdown())
            loop.call(watcher.close())
            loop.call(disc.stop())
            loop.close()
    row["events"] = [(round(t, 3), e["op"], e["key"]) for t, e in events]
    row["expired"] = [e["key"] for _, e in events if e["op"] == "expire"]
    row["ports_free"] = _ports_free(ports)
    row["seconds"] = time.perf_counter() - t_phase
    fused = {k: {"b": row["launches_b"].get(k, {}).get("fused", 0),
                 "c": row["launches_c"].get(k, {}).get("fused", 0)}
             for k in ("crop_resize", "flash_attention")}
    row["fused"] = fused
    row["within_limits"] = (
        row["websocket"]["word_diffs_vs_serve"] <= SERVE_WORD_DIFFS
        and fused["crop_resize"] == {"b": SERVE_PAIRS, "c": SERVE_PAIRS + 4}
        and fused["flash_attention"] == {"b": 6 * SERVE_PAIRS, "c": 6 * (SERVE_PAIRS + 4)}
        and all(row[p]["word_diffs_vs_websocket"] <= SERVE_WORD_DIFFS for p in ("http", "grpc"))
        and row["preflight"] == {"status": 204, "Access-Control-Allow-Origin": "*",
                                 "Access-Control-Allow-Methods": "*",
                                 "Access-Control-Allow-Headers": "*"}
        and row["trace"]["client"] and row["trace"]["gateway_rpc"] and row["trace"]["pool"]
        and row["cloud"]["ping"] == [200, {}]
        and row["cloud"]["word_diffs_vs_websocket"] <= SERVE_WORD_DIFFS
        and row["deregister_s"] is not None and row["deregister_s"] <= GATEWAY_DEREGISTER_S
        and row["register_s"] is not None
        and row["pod_close_s"] <= SERVE_CLOSE_S and row["pod_exitcode"] == 0
        and not row["expired"] and all(row["ports_free"]))
    emit(row)
    if not row["within_limits"]:
        raise AssertionError(f"gateway checks failed: {row}")
    return {k: {"fused": row["launches"].get(k, {}).get("fused", 0),
                "cloud_fused": row["cloud"]["launches"][k].get("fused", 0)}
            for k in ("crop_resize", "flash_attention")}


STATEFUL_REPLICAS = 3
STATEFUL_BEFORE = 4  # pairs 0-3, one at a time, before the leader's kill
STATEFUL_AFTER = 2  # pairs 4 and 5 after it
STATEFUL_FAILOVER_S = 30.0  # SIGKILL to a new leader, and to the first answered write
STATEFUL_LEADER_S = 30.0  # the pods' readiness to a first leader
STATEFUL_APPLY_S = 30.0  # an answered write to its application on every live replica
STATEFUL_BUNDLE = ("ocr-extract", "1.0.0")
# the hub bundle: the serve phase's worker, a work directory of each replica's own
# (every replica applies the same requests)
STATEFUL_CONFIG = """jtype: TextExtractionExecutor
with:
  ocr_engine: default
  device: cuda
  work_dir: ${{ ENV.MARIE_STATEFUL_WORK }}/${{ ENV.MARIE_RAFT_NODE_ID }}
py_modules:
  - executor.py
"""
STATEFUL_MODULE = ("# registers the jtype of config.yml\n"
                   "from marie_tpu_torch.executor import TextExtractionExecutor  # noqa: F401\n")


def _bundle_registry():
    """A remote hub registry in this process (``GET/PUT /v1/bundles/<name>/<version>``,
    ``GET /v1/index/<name>``) on a thread: (server, url)."""
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    bundles = {}

    class Registry(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def _send(self, code, body=b""):
            self.send_response(code)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_PUT(self):
            _, _, kind, name, version = self.path.split("/")
            data = self.rfile.read(int(self.headers.get("Content-Length", 0)))
            bundles[(name, version)] = (data, self.headers.get("X-Bundle-Sha256", ""))
            self._send(200)

        def do_GET(self):
            parts = self.path.split("/")
            if parts[2] == "index":
                self._send(200, json.dumps({v: {"sha256": d} for (n, v), (_, d)
                                            in bundles.items() if n == parts[3]}).encode())
                return
            item = bundles.get((parts[3], parts[4]))
            self._send(200, item[0]) if item else self._send(404)

    server = ThreadingHTTPServer(("127.0.0.1", 0), Registry)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


def _ports_unbound(ports) -> list:
    """Whether a server could bind each port again (SO_REUSEADDR, as the
    servers bind): no socket listens there.  For a killed process's ports,
    whose connections the kernel closed and left in TIME_WAIT."""
    import socket

    free = []
    for port in ports:
        with socket.socket() as s:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            try:
                s.bind(("127.0.0.1", port))
                free.append(True)
            except OSError:
                free.append(False)
    return free


def phase_stateful(shipped, http_pages, grpc_p50_ms):
    """RAFT-replicated OCR workers from a hub bundle, behind a gRPC gateway.

    (a) A hub bundle (``config.yml`` of ``jtype: TextExtractionExecutor``
    configured as the ``serve`` phase's worker, its ``py_modules``) pushed
    to a hub under a temporary directory and to a remote registry served
    by this process (``MARIE_HUB_REGISTRY``); its resolve and install
    timed here, into the directories the pods then read (``env``).  (b)
    ``Flow().add(uses="hub://ocr-extract:1.0.0", replicas=3,
    stateful=True)`` behind a gRPC gateway, warm-up on; a first leader.
    (c) Pairs 0-3 of the 16 shipped pages as four 2-page
    ``/document/extract`` writes, one at a time through the gateway (the
    executor declares no ``@write``: every request replicates; the pool
    retries a follower's "not the leader").  (d) SIGKILL of the leader's
    pod, then pairs 4 and 5.  (e) The Flow closed.  Gates: every answer's
    words equal the ``serve`` phase's for its pair (0 differences); every
    live replica's commit and applied index equal the writes, read from
    its ``info()["raft"]`` through gRPC ``_status``; K1 1 / K2 6 on
    ``"fused"`` a write on every live replica (warm-up apart): K1 4 / K2
    24 on each of the three before the kill, K1 6 / K2 36 on both
    survivors after it (no write applied twice); a new leader within
    STATEFUL_FAILOVER_S of the kill, and the first write after it answered
    within that too; every pod gone within SERVE_CLOSE_S and every port of
    the phase free (the killed pod's and the registry's, which close their
    connections first and so wait in TIME_WAIT: nothing listens there).
    Reports the
    pods' start s, the bundle's push and resolve s, write ms (first, p50)
    beside ``grpc``'s one-at-a-time p50, the re-election and failover s.
    Returns the launches: ``{kernel: {"fused": the replicas' sum}}``."""
    import asyncio
    import tempfile

    from marie_tpu_torch.clients import GRPCClient
    from marie_tpu_torch.hub import ExecutorHub
    from marie_tpu_torch.orchestrate.flow import Flow
    from marie_tpu_torch.types import Document

    t_phase = time.perf_counter()
    pages = list(shipped["pages"])
    h, w = pages[0].shape
    n_writes = STATEFUL_BEFORE + STATEFUL_AFTER
    pairs = [pages[2 * i:2 * i + 2] for i in range(n_writes)]
    name, (bundle, version) = "extract", STATEFUL_BUNDLE
    ref = f"hub://{bundle}:{version}"
    row = {"phase": "stateful", "replicas": STATEFUL_REPLICAS, "uses": ref,
           "writes": n_writes, "grpc_p50_ms": grpc_p50_ms}

    def docs_of(i, pair):
        return [Document(id=f"s{i}-{k}", tensor=p) for k, p in enumerate(pair)]

    async def raft_info(pod):
        client = GRPCClient(port=pod.port)
        try:
            info = await client.ainfo(timeout=10)
        finally:
            await client.aclose()
        launches = info.get("kernel_launches", {})
        return info["raft"], {k: launches.get(k, {}).get("fused", 0)
                              for k in ("crop_resize", "flash_attention")}

    async def infos(pods):
        return await asyncio.gather(*(raft_info(p) for p in pods))

    async def applied(pods, want):
        """Every pod's raft state once each has applied ``want`` entries."""
        deadline = time.perf_counter() + STATEFUL_APPLY_S
        got = await infos(pods)
        while {r["applied_index"] for r, _ in got} != {want} \
                and time.perf_counter() < deadline:
            await asyncio.sleep(0.05)
            got = await infos(pods)
        return got

    async def leader_of(pods, not_this=""):
        deadline = time.perf_counter() + STATEFUL_FAILOVER_S
        while time.perf_counter() < deadline:
            leaders = {r["leader"] for r, _ in await infos(pods)}
            if len(leaders) == 1 and "" not in leaders and not_this not in leaders:
                return leaders.pop()
            await asyncio.sleep(0.05)
        return None

    registry, url = _bundle_registry()
    answers, write_ms = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        # (a) the bundle
        pkg = os.path.join(tmp, "bundle", bundle)
        os.makedirs(pkg)
        with open(os.path.join(pkg, "config.yml"), "w") as fp:
            fp.write(STATEFUL_CONFIG)
        with open(os.path.join(pkg, "executor.py"), "w") as fp:
            fp.write(STATEFUL_MODULE)
        env = {"MARIE_HUB_REGISTRY": url, "MARIE_HUB_DIR": os.path.join(tmp, "hub"),
               "MARIE_HUB_INSTALL": os.path.join(tmp, "install"),
               "MARIE_STATEFUL_WORK": os.path.join(tmp, "work")}
        t = time.perf_counter()
        ExecutorHub(hub_dir=os.path.join(tmp, "publisher"), registry_url=url).push(
            pkg, bundle, version)
        row["bundle_push_s"] = time.perf_counter() - t
        t = time.perf_counter()
        installed = ExecutorHub(hub_dir=env["MARIE_HUB_DIR"], registry_url=url,
                                install_dir=env["MARIE_HUB_INSTALL"]).resolve(ref)
        row["bundle_resolve_s"] = time.perf_counter() - t
        row["bundle_installed"] = os.path.relpath(installed, tmp)

        # (b) the stateful Flow
        flow = Flow().add(name=name, uses=ref, uses_with={"device": SERVER_DEVICE},
                          replicas=STATEFUL_REPLICAS, stateful=True, env=env)
        t = time.perf_counter()
        flow.start()
        row["pods_start_s"] = time.perf_counter() - t
        pods = list(flow._deployments[name].pods)
        ports = [p.port for p in flow.pods] + [int(p.kwargs["raft"]["bind_addr"].rsplit(":")[1])
                                               for p in pods]
        killed = None
        try:
            async def drive():
                out = {}
                t0 = time.perf_counter()
                out["leader"] = await leader_of(pods)
                out["leader_s"] = time.perf_counter() - t0
                out["start"] = await infos(pods)
                client = GRPCClient(port=flow.port_gateway)

                async def write(i, **kwargs):
                    t = time.perf_counter()
                    resp = await client.apost("/document/extract", docs_of(i, pairs[i]),
                                              parameters={"ref_id": f"pair-{i}"},
                                              return_responses=True, timeout=900, **kwargs)
                    write_ms.append((time.perf_counter() - t) * 1e3)
                    answers[i] = _grpc_pages(resp, len(pairs[i]), h, w)

                # (c) the writes
                for i in range(STATEFUL_BEFORE):
                    await write(i)
                out["before"] = await applied(pods, STATEFUL_BEFORE)
                # (d) the leader's kill
                leader = pods[int(out["leader"].rsplit("-", 1)[1])]
                survivors = [p for p in pods if p is not leader]
                t_kill = time.perf_counter()
                leader._process.kill()
                leader._process.join(10)
                out["killed"] = leader
                out["new_leader"] = await leader_of(survivors, not_this=out["leader"])
                out["reelect_s"] = time.perf_counter() - t_kill
                first = None
                while first is None and time.perf_counter() - t_kill < STATEFUL_FAILOVER_S:
                    try:
                        await write(STATEFUL_BEFORE, max_attempts=3, initial_backoff=0.2)
                        first = time.perf_counter() - t_kill
                    except Exception as ex:  # noqa: BLE001 — an election in progress: again
                        out.setdefault("retried", []).append(repr(ex)[:200])
                        await asyncio.sleep(0.2)
                out["failover_s"] = first
                for i in range(STATEFUL_BEFORE + 1, n_writes):
                    await write(i)
                out["after"] = await applied(survivors, n_writes)
                await client.aclose()
                return out

            d = asyncio.run(drive())
            killed = d["killed"]
        except BaseException:
            row["exitcodes_at_failure"] = [p.exitcode for p in pods]
            row["write_ms"], row["answered"] = write_ms, sorted(answers)
            emit(row)
            raise
        finally:
            t = time.perf_counter()
            flow.close()
            row["close_s"] = time.perf_counter() - t
            registry.shutdown()
            registry.server_close()
        row["exitcodes"] = [p.exitcode for p in pods]
        own = [p.port for p in pods if p is killed] + \
              [int(p.kwargs["raft"]["bind_addr"].rsplit(":")[1]) for p in pods if p is killed]
        row["ports_free"] = _ports_free([p for p in ports if p not in own])
        # the registry answers HTTP/1.0 and closes first: its port waits in TIME_WAIT
        row["killed_ports_unbound"] = _ports_unbound(own + [registry.server_port])
    row["leader"], row["new_leader"] = d["leader"], d["new_leader"]
    row["leader_s"], row["reelect_s"], row["failover_s"] = (d["leader_s"], d["reelect_s"],
                                                           d["failover_s"])
    row["retried_writes"] = d.get("retried", [])
    for part in ("start", "before", "after"):
        row[part] = [{"id": next(s["id"] for s in r["servers"] if s["self"]), "leader": r["leader"],
                      "term": r["term"], "commit_index": r["commit_index"],
                      "applied_index": r["applied_index"], "fused": counts}
                     for r, counts in d[part]]
    row["write_ms"] = write_ms
    row["write_first_ms"] = write_ms[0]
    row["write_p50_ms"] = _percentile(write_ms, 0.5)
    row["word_diffs_vs_serve"] = sum(
        _word_diffs(answers.get(i, []), http_pages[2 * i:2 * i + 2])
        + abs(len(answers.get(i, [])) - len(pairs[i])) for i in range(n_writes))
    row["seconds"] = time.perf_counter() - t_phase

    def counts_are(part, writes):
        return all(r["commit_index"] == r["applied_index"] == writes
                   and r["fused"] == {"crop_resize": writes, "flash_attention": 6 * writes}
                   for r in row[part])

    row["within_limits"] = (
        row["word_diffs_vs_serve"] == SERVE_WORD_DIFFS and len(answers) == n_writes
        and all(r["fused"] == {"crop_resize": 0, "flash_attention": 0} for r in row["start"])
        and len(row["before"]) == STATEFUL_REPLICAS and counts_are("before", STATEFUL_BEFORE)
        and len(row["after"]) == STATEFUL_REPLICAS - 1 and counts_are("after", n_writes)
        and row["new_leader"] is not None and row["new_leader"] != row["leader"]
        and row["reelect_s"] <= STATEFUL_FAILOVER_S
        and row["failover_s"] is not None and row["failover_s"] <= STATEFUL_FAILOVER_S
        and row["close_s"] <= SERVE_CLOSE_S and all(c is not None for c in row["exitcodes"])
        and all(row["ports_free"]) and all(row["killed_ports_unbound"]))
    emit(row)
    if not row["within_limits"]:
        raise AssertionError(f"stateful checks failed: {row}")
    before = {r["id"]: r["fused"] for r in row["before"]}
    after = {r["id"]: r["fused"] for r in row["after"]}
    return {k: {"fused": sum({**before, **after}[i][k] for i in before)}
            for k in ("crop_resize", "flash_attention")}


PARALLEL_ENTRIES = 2  # a local mesh of two entries of the one card; a world of two ranks on it
PARALLEL_TRAIN_SHAPES = ((2, 1), (1, 2))  # (data, model)
PARALLEL_TRAIN_STEPS = 3
PARALLEL_TRAIN_SEED = SEED + 100  # init_flax_defaults' tree at fast_v3_g2_d6's width
PARALLEL_TRAIN_BATCH = 64  # crops of the shipped pages' truth words
PARALLEL_TOL = 1e-5  # train loss (relative) and parameters (of each leaf's largest);
# the pipeline, expert and sequence legs against their plain composition
PARALLEL_GRAD_LIMIT = 5e-5  # each step's gradients, of each leaf's largest
PARALLEL_RESOLVED = 0.5  # the least share of the live leaves' elements that resolve
PARALLEL_LR = 1e-4  # optax.adamw(1e-4), the training step's optimizer
PARALLEL_WORLD_S = 300.0


def _parallel_batch(shipped, tokenizer):
    """(images [64, 48, 320, 3] float32, tokens [64, 32] int64): the first
    64 truth words of the shipped pages cut with K1 at the recogniser's
    crop size, and their characters after BOS, with EOS, padded."""
    import numpy as np
    import torch

    from marie_tpu_torch.models.configs import TrOCRConfig
    from marie_tpu_torch.ops.kernels.crop_resize import crop_resize

    cfg = TrOCRConfig.fast_v3_g2_d6()
    words = [(i, w, b) for i, page in enumerate(shipped["truth"]["pages"]) for w, b in page]
    words = words[:PARALLEL_TRAIN_BATCH]
    pages = torch.from_numpy(np.ascontiguousarray(shipped["pages"])).cuda()
    boxes = torch.tensor([[x, y, x + w, y + h] for _, _, (x, y, w, h) in words],
                         dtype=torch.float32, device="cuda")
    page_of = torch.tensor([i for i, _, _ in words], dtype=torch.int32, device="cuda")
    h, w = cfg.encoder.image_size
    crops, _ = crop_resize(pages, page_of, boxes, h, w)
    images = crops[..., None].expand(*crops.shape, 3).cpu().numpy().astype(np.float32)
    n = cfg.decoder.max_len
    rows = []
    for _, text, _ in words:
        ids = ([cfg.decoder.bos_id] + tokenizer.encode(text, add_eos=True))[:n]
        rows.append(ids + [cfg.decoder.pad_id] * (n - len(ids)))
    return images, np.asarray(rows, np.int64)


def _train_compare(world, ref, live, resolved) -> dict:
    """A world run's losses, gradients and parameters against the one-rank
    run's, on the card: losses (relative), each step's gradients of the
    live leaves (of each leaf's largest) and the parameters (of each
    leaf's largest) where the gradient resolves; ``live`` and
    ``resolved`` are :func:`~marie_tpu_torch.parallel.check.step_masks`'
    of the one-rank run, with a gradient error of PARALLEL_GRAD_LIMIT."""
    from marie_tpu_torch.parallel.check import resolved_share

    (losses, state, grads), (ref_losses, ref_state, ref_grads) = world, ref
    param_err, worst = 0.0, None
    for name, w in ref_state.items():
        ok = resolved[(name,)]
        if bool(ok.any()):
            err = float((state[name] - w).abs()[ok].max()) / float(w.abs().max())
            if err > param_err:
                param_err, worst = err, name
    grad_err = max(float((g_step[name] - r).abs().max()) / max(float(r.abs().max()), 1e-30)
                   for g_step, r_step in zip(grads, ref_grads)
                   for name, r in r_step.items() if live[(name,)])
    return {"losses": losses, "ref_losses": ref_losses,
            "loss_err": max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)),
            "param_err": param_err, "worst_leaf": worst, "grad_err": grad_err,
            "resolved_share": resolved_share(live, resolved),
            "noise_leaves": sorted(k[0] for k, v in live.items() if not v)}


def _train_run(mesh, tree, images, tokens):
    """PARALLEL_TRAIN_STEPS steps of the sharded step at the serving
    recogniser's width: (losses, every parameter after them, each step's
    gradients), whole on the card on every rank."""
    from marie_tpu_torch.models.configs import TrOCRConfig
    from marie_tpu_torch.ops.kernels._build import launch_path
    from marie_tpu_torch.parallel import make_train_step
    from marie_tpu_torch.registry.convert import build_model

    init_fn, step_fn = make_train_step(build_model(TrOCRConfig.fast_v3_g2_d6()), mesh)
    params, opt_state = init_fn(tree)
    images, tokens = step_fn.place_batch(images, tokens)
    losses, grads = [], []
    for _ in range(PARALLEL_TRAIN_STEPS):
        with launch_path("train"):
            params, opt_state, loss = step_fn(params, opt_state, images, tokens)
        losses.append(float(loss))
        grads.append(step_fn.full_state(params, grads=True))
    return losses, step_fn.full_state(params), grads


def parallel_world_rank(images, tokens):
    """One rank of the ``parallel`` phase's world of two on the card: the
    training step on meshes (2, 1) and (1, 2) from init_flax_defaults'
    tree (PARALLEL_TRAIN_SEED), the dryrun's world legs (pipeline,
    expert, sequence; they raise outside 1e-5), then rank 0 holds the
    step to its own one-rank run.  Returns this rank's figures and K2's
    launches on ``"train"``."""
    import torch
    import torch.distributed as dist

    from marie_tpu_torch.models.configs import TrOCRConfig
    from marie_tpu_torch.ops.kernels.flash_attention import (
        flash_attention,
        flash_attention_backward,
    )
    from marie_tpu_torch.parallel import create_mesh
    from marie_tpu_torch.parallel.check import step_masks
    from marie_tpu_torch.parallel.distributed import world_device, world_staged
    from marie_tpu_torch.parallel.dryrun import world_legs
    from marie_tpu_torch.registry.convert import init_flax_defaults

    rank = dist.get_rank()
    tree = init_flax_defaults(TrOCRConfig.fast_v3_g2_d6(), PARALLEL_TRAIN_SEED)
    out = {"rank": rank, "device": str(world_device()), "backend": dist.get_backend(),
           "staged": world_staged()}
    _reset_counts()
    runs = {}
    for shape in PARALLEL_TRAIN_SHAPES:
        t = time.perf_counter()
        run = _train_run(create_mesh(shape), tree, images, tokens)
        runs[shape] = run if rank == 0 else None  # rank 0 compares
        torch.cuda.synchronize()
        out[f"train_{shape[0]}x{shape[1]}_s"] = time.perf_counter() - t
    out["launches"] = {fn.__name__: fn.launches_by_path.get("train", 0)
                       for fn in (flash_attention, flash_attention_backward)}
    t = time.perf_counter()
    legs = world_legs()
    out["legs"] = {k: legs[k] for k in ("pipeline", "moe", "seq")}
    out["legs_s"] = time.perf_counter() - t
    if rank == 0:  # after the world's last collective: no rank waits on this
        ref = _train_run(create_mesh((1, 1), devices=[world_device()]), tree, images, tokens)
        live, resolved = step_masks(ref[2], ref[1], PARALLEL_TOL, PARALLEL_GRAD_LIMIT,
                                    PARALLEL_LR)
        out["train"] = {f"{s[0]}x{s[1]}": _train_compare(runs[s], ref, live, resolved)
                        for s in runs}
    return out


def _nccl_world() -> dict:
    """A one-rank NCCL world in this process on the card: initialise,
    all-reduce, leave."""
    import tempfile

    import torch
    import torch.distributed as dist

    from marie_tpu_torch.parallel.distributed import (
        initialize_distributed,
        shutdown_distributed,
        world_device,
    )

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="marie-nccl-") as tmp:
        initialize_distributed(f"file://{os.path.join(tmp, 'store')}", 1, 0, device="cuda",
                               backend="nccl")
        try:
            x = torch.arange(4, dtype=torch.float32, device=world_device())
            dist.all_reduce(x)
            torch.cuda.synchronize()
            return {"backend": dist.get_backend(), "all_reduce": x.tolist(),
                    "seconds": time.perf_counter() - t0}
        finally:
            shutdown_distributed()


def _stats_diffs(got, want) -> int:
    return sum(int((got[k] != want[k]).sum()) for k in want)


def phase_parallel(shipped, trained_engine):
    """Parallelism on the card (``marie_tpu_torch/parallel/``).

    (a) Mesh serving at full width: the trained engine's configuration on
    the 16 shipped pages with a local mesh of two entries of the one card:
    ``fused_ocr_pages`` on the engine's u2 upload of the 16 pages, the
    engine's stream with the chained heads (``PipelineOcrEngine(mesh=)``),
    and ``fused_ocr_chain``, each against the same call without the mesh.
    Gates: 0 differing stats, token rows, words and boxes, equal page and
    NER labels, class logits within 1e-5; K1 once and K2 once a layer per
    entry on ``"fused"`` (K1 2, K2 12), the heads' K2 per entry on
    ``"heads"`` (16); the stream's group split.  ms/page beside the
    unsharded run's (informational).  (b) A world of two gloo ranks on
    the card (NCCL refuses two ranks on one GPU; the collectives go
    through host memory): the training step at the serving recogniser's
    width (fast_v3_g2_d6) on meshes (2, 1) and (1, 2), 3 steps on 64 crops
    of the shipped pages' truth words from a seeded tree of flax's
    initialisers (the zoo's tree is trained on these words: its gradients
    are near zero, and AdamW's steps would follow float32 noise), held to
    a one-rank run (loss within 1e-5 relative; gradients within 1e-4 of
    each leaf's largest; parameters within 1e-5 of each leaf's largest
    where the gradient resolves, which must be more than half of the
    elements), K2 and its gradient launched on ``"train"``; the pipeline
    (2 stages), expert (2) and sequence (2-way) legs within 1e-5 of their
    plain composition; and a one-rank NCCL world in this process that
    initialises and all-reduces.  Returns the launches of (a) and (b) by
    path."""
    import torch

    from marie_tpu_torch.ocr import fused as tfused
    from marie_tpu_torch.ocr.fused_chain import fused_ocr_chain
    from marie_tpu_torch.ocr.ocr_engine import PipelineOcrEngine
    from marie_tpu_torch.parallel import create_mesh
    from marie_tpu_torch.parallel.distributed import spawn_world

    t_phase = time.perf_counter()
    eng = trained_engine
    bp, op, heads = eng.box_processor, eng.ocr_processor, (eng.classifier, eng.indexer)
    pages = list(shipped["pages"])
    n = len(pages)
    mesh = create_mesh((PARALLEL_ENTRIES,), ("pages",), devices=["cuda:0"] * PARALLEL_ENTRIES)
    row = {"phase": "parallel", "entries": PARALLEL_ENTRIES, "pages": n}
    launches = {}

    # (a) fused_ocr_pages on the engine's upload of the 16 pages
    preps = [bp.prep_page(p) for p in pages]
    stack, clip, psize, packed = tfused._upload_group(
        preps, list(range(n)), eng.page_fuse_batch, eng.upload_format, bp.device)
    kw = dict(n_real=n, total_slots=psize * eng.compact_slots, packed=packed)
    want = tfused.fused_ocr_pages(bp, op, stack, clip, **kw)
    torch.cuda.synchronize()
    _reset_counts()
    got = tfused.fused_ocr_pages(bp, op, stack, clip, mesh=mesh, **kw)
    torch.cuda.synchronize()
    launches["pages"] = _read_counts()
    row["pages_call"] = {"stats_diffs": _stats_diffs(got[0], want[0]),
                         "token_row_diffs": int((got[1] != want[1]).any(dim=1).sum()),
                         "rows": int(got[1].shape[0]),
                         "kept": int(tfused.keep_predicate(got[0], bp.box_source,
                                                           bp.text_threshold,
                                                           float(bp.min_area)).sum()),
                         "conf_max_abs_err": float((got[2] - want[2]).abs().max()),
                         "launches": launches["pages"]}

    # the engine's stream with the chained heads, with and without the mesh
    meshed = PipelineOcrEngine(bp, op, upload_format=eng.upload_format,
                               compact_slots=eng.compact_slots,
                               page_fuse_batch=eng.page_fuse_batch, classifier=heads[0],
                               indexer=heads[1], mesh=mesh)
    meshed.extract(pages)  # each entry thread's first stream group
    groups = dict(tfused.MESH_GROUPS)
    t0 = time.perf_counter()
    want_res = eng.extract(pages)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    _reset_counts()
    t0 = time.perf_counter()
    got_res = meshed.extract(pages)
    torch.cuda.synchronize()
    mesh_s = time.perf_counter() - t0
    launches["stream"] = _read_counts()
    row["stream"] = {
        "word_diffs": _word_diffs(got_res, want_res),
        "label_diffs": sum(g["classification"]["label"] != w["classification"]["label"]
                           for g, w in zip(got_res, want_res)),
        "ner_diffs": sum(a.get("ner_label") != b.get("ner_label")
                         for g, w in zip(got_res, want_res)
                         for a, b in zip(g["words"], w["words"])),
        "words": sum(len(r["words"]) for r in got_res),
        "groups_sharded": tfused.MESH_GROUPS["sharded"] - groups["sharded"],
        "groups_unsharded": tfused.MESH_GROUPS["unsharded"] - groups["unsharded"],
        "ms_per_page": mesh_s / n * 1e3, "unsharded_ms_per_page": plain_s / n * 1e3,
        "launches": launches["stream"]}

    # fused_ocr_chain with the trained heads
    want_c = fused_ocr_chain(bp, op, *heads, stack, clip, **kw)
    got_c = fused_ocr_chain(bp, op, *heads, stack, clip, mesh=mesh, **kw)
    torch.cuda.synchronize()
    row["chain_call"] = {
        "stats_diffs": _stats_diffs(got_c[0], want_c[0]),
        "token_row_diffs": int((got_c[1] != want_c[1]).any(dim=1).sum()),
        "cls_logits_err": float((got_c[3] - want_c[3]).abs().max()),
        "ner_label_diffs": int((got_c[4] != want_c[4]).sum())}
    row["serve_s"] = time.perf_counter() - t_phase
    emit({**row, "part": "serve"})

    # (b) the world: train at full width, then the pipeline, expert and sequence legs
    t0 = time.perf_counter()
    images, tokens = _parallel_batch(shipped, op.tokenizer)
    ranks = spawn_world(parallel_world_rank, PARALLEL_ENTRIES, args=(images, tokens),
                        device="cuda", timeout_s=PARALLEL_WORLD_S)
    row["world"] = {"ranks": [{k: v for k, v in r.items() if k != "train"} for r in ranks],
                    "train": ranks[0]["train"], "seconds": time.perf_counter() - t0}
    row["nccl"] = _nccl_world()
    row["seconds"] = time.perf_counter() - t_phase
    train_launches = {k: sum(r["launches"][k] for r in ranks)
                      for k in ("flash_attention", "flash_attention_backward")}
    row["world"]["train_launches"] = train_launches

    pc, st, wd = row["pages_call"], row["stream"], row["world"]
    layers = op.model.cfg.encoder.num_layers
    row["within_limits"] = (
        pc["stats_diffs"] == 0 and pc["token_row_diffs"] == 0
        and pc["launches"]["crop_resize"].get("fused") == PARALLEL_ENTRIES
        and pc["launches"]["flash_attention"].get("fused") == PARALLEL_ENTRIES * layers
        and st["word_diffs"] == 0 and st["label_diffs"] == 0 and st["ner_diffs"] == 0
        and st["groups_sharded"] == 1 and st["groups_unsharded"] == 0
        and st["launches"]["crop_resize"].get("fused") == PARALLEL_ENTRIES
        and st["launches"]["flash_attention"].get("fused") == PARALLEL_ENTRIES * layers
        and st["launches"]["flash_attention"].get("heads") == 8 * PARALLEL_ENTRIES
        and row["chain_call"]["stats_diffs"] == 0 and row["chain_call"]["token_row_diffs"] == 0
        and row["chain_call"]["cls_logits_err"] <= PARALLEL_TOL
        and row["chain_call"]["ner_label_diffs"] == 0
        and all(r["backend"] == "gloo" and r["staged"] for r in wd["ranks"])
        and all(t["loss_err"] <= PARALLEL_TOL and t["param_err"] <= PARALLEL_TOL
                and t["grad_err"] <= PARALLEL_GRAD_LIMIT
                and t["resolved_share"] > PARALLEL_RESOLVED
                for t in wd["train"].values())
        and all(leg["max_abs_err"] <= PARALLEL_TOL
                for r in wd["ranks"] for leg in r["legs"].values())
        and all(v > 0 for v in train_launches.values())
        and row["nccl"]["backend"] == "nccl" and row["nccl"]["all_reduce"] == [0.0, 1.0, 2.0, 3.0])
    emit(row)
    if not row["within_limits"]:
        raise AssertionError(f"parallel checks failed: {row}")
    return {name: {"parallel_pages": launches["pages"][name].get("fused", 0),
                   "parallel_fused": launches["stream"][name].get("fused", 0),
                   "parallel_heads": launches["stream"][name].get("heads", 0),
                   **({"parallel_train": train_launches[name]}
                      if name == "flash_attention" else {})}
            for name in ("crop_resize", "flash_attention")}, train_launches


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
    launches, chain_results = run("chain", phase_chain, setups, pages)
    cls_tree, ner_tree = run("layoutlm_base", phase_layoutlm_base, pages, chain_results)
    shipped = run("trained", load_shipped)
    trained_engine, trained_launches = run("trained", phase_trained, shipped)
    forms_launches = run("forms", phase_forms, trained_engine, shipped)
    best, best_launches = run("best", phase_best, shipped)
    classify_launches = run("classify", phase_classify, shipped, trained_engine, cls_tree)
    extract_launches, extract_setups = run("extract", phase_extract, shipped, cls_tree,
                                           ner_tree)
    del cls_tree
    register_launches, _ = run("register", phase_register, shipped)
    detector_launches, _ = run("detectors", phase_detectors, shipped,
                                             trained_engine)
    reading_launches = run("reading_order", phase_reading_order, shipped, trained_engine)
    k2_bwd, train_launches = run("train", phase_train, shipped, trained_engine)
    _, ocr_launches = run("ocr_train", phase_ocr_train, shipped)
    train_launches.update(ocr_launches)
    run("runtime", phase_runtime, shipped, trained_engine)
    run("rotated", phase_rotated)
    single_launches = run("single", phase_single, shipped, trained_engine)
    serve_launches, http_pages = run("serve", phase_serve, shipped, ner_tree)
    del ner_tree
    grpc_launches, grpc_p50_ms = run("grpc", phase_grpc, shipped, http_pages)
    server_launches = run("server", phase_server, shipped, http_pages)
    gateway_launches = run("gateway", phase_gateway, shipped, http_pages)
    stateful_launches = run("stateful", phase_stateful, shipped, http_pages, grpc_p50_ms)
    parallel_launches, parallel_train = run("parallel", phase_parallel, shipped, trained_engine)
    run("profile", phase_profile,
        {"trained": (trained_engine, shipped["pages"]),
         # one page: tracing the best engine's ~8,700 launches a page
         # costs the profiler ~8 s a page
         "best": (best, list(shipped["pages"][:1])), **extract_setups})
    # the trained engine's 16-page run is the main path (OCR program and
    # chained heads); the forms phase adds the fragments path, the best
    # phase the voting engine's recognisers
    for row, name in ((k1, "crop_resize"), (k2, "flash_attention")):
        row["launches"] = trained_launches[name]["all"]
        row["launches_by_path"] = {
            **{k: v for k, v in trained_launches[name].items() if k != "all"},
            "fragments": forms_launches[name].get("fragments", 0),
            "best": best_launches[name].get("best", 0),
            **{f"classify_{p}_{k}": v for p in CLASSIFY_PASSES
               for k, v in classify_launches[p][name].items() if k != "all"},
            "embeddings": classify_launches["embeddings"][name].get("embeddings", 0),
            **{f"extract_{part}_{k}": v for part, counts in extract_launches.items()
               for k, v in counts[name].items() if k != "all"},
            **{f"extract_register_{p}_{k}": v for p, counts in register_launches.items()
               for k, v in counts[name].items() if k != "all"},
            **{f"detectors_{part}_{k}": v for part, counts in detector_launches.items()
               for k, v in counts[name].items() if k != "all"},
            "reading_order": reading_launches[name].get("reading_order", 0),
            **{run_name: counts[name].get("train", 0)
               for run_name, counts in train_launches.items()},
            "single": single_launches[name].get("single", 0),
            **{f"serve_{k}": v for k, v in serve_launches[name].items()},
            **{f"grpc_{k}": v for k, v in grpc_launches[name].items() if k != "all"},
            **{f"server_{k}": v for k, v in server_launches[name].items()},
            **{f"gateway_{k}": v for k, v in gateway_launches[name].items()},
            **{f"stateful_{k}": v for k, v in stateful_launches[name].items()},
            **parallel_launches[name]}
    # the gradient runs only in the trainers: its launches are theirs
    k2_bwd["launches_by_path"] = {
        **{run_name: counts["flash_attention_backward"].get("train", 0)
           for run_name, counts in train_launches.items()},
        "parallel_train": parallel_train["flash_attention_backward"]}
    k2_bwd["launches"] = sum(k2_bwd["launches_by_path"].values())
    emit({"phase": "done", "wall_s": round(time.perf_counter() - t0, 3), "phase_s": phase_s})
    print(card, flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "launches_by_path",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{k: row[k] for k in keys} for row in (k1, k2, k2_bwd)]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
