"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test is marked ``cuda`` and skips without a CUDA device.

This module imports nothing of JAX, so it also runs on a machine without
it, with the JAX-side ``conftest.py`` left out:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import os

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
@pytest.mark.parametrize("out_hw", [(48, 320), (32, 64), (48, 321), (20, 77), (32, 256)])
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
    x = torch.zeros(1, 1, 4, 68, device=cuda_device)
    with pytest.raises(ValueError):
        k2.flash_attention(*(x[..., 1:65],) * 3)  # float32 rows 4 bytes off 16
    x = torch.zeros(1, 1, 4, 66, device=cuda_device)
    with pytest.raises(ValueError):
        k2.flash_attention(*(x[..., :64],) * 3)  # float32 row stride of 264 bytes
    with pytest.raises(ValueError):
        k1.crop_resize(torch.zeros(1, 8, 8, device=cuda_device),  # not uint8
                       torch.zeros(1, dtype=torch.int32, device=cuda_device),
                       torch.zeros(1, 4, device=cuda_device), 4, 4)


def _ink_page(seed, h, w, n_words=20):
    """A white page with word-shaped ink blocks."""
    rng = np.random.default_rng(seed)
    page = np.full((h, w), 255, np.uint8)
    for _ in range(n_words):
        ww, th = int(rng.integers(20, 120)), int(rng.integers(12, 24))
        x, y = int(rng.integers(4, w - ww - 4)), int(rng.integers(4, h - th - 4))
        page[y:y + th, x:x + ww] = int(rng.integers(0, 90))
        page[y:y + th, x + 2:x + ww:6] = 255
    return page


@pytest.mark.cuda
def test_cuda_default_craft_ignores_global_tf32(cuda_device):
    """A default (float32, allow_tf32=False) BoxProcessorCraft gives the
    same heatmap with the global TF32 flags on as with them off, and
    leaves the flags as it found them."""
    from marie_tpu_torch.boxes.craft_box_processor import BoxProcessorCraft
    from marie_tpu_torch.utils.device import _precision_flags

    read, write, _ = _precision_flags()
    start = read()
    pages = np.stack([_ink_page(s, 512, 384) for s in range(2)])
    bp = BoxProcessorCraft(device=cuda_device)
    try:
        write(("ieee",) * len(start))
        off = bp.heatmap(pages)
        write(("tf32",) * len(start))
        on = bp.heatmap(pages)
        assert read() == ("tf32",) * len(start)
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        legacy = bp.heatmap(pages)
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        write(start)
    assert torch.equal(on, off) and torch.equal(legacy, off)


@pytest.mark.cuda
def test_cuda_recognize_dispatch_matches_cpu(cuda_device):
    """TrOcrProcessor.recognize_dispatch on the card (K1 and K2) equals
    the CPU path: a full chunk of 256 rows and one of 3 padded to 32, with
    a box taller than the JAX Pallas crop window (224 rows)."""
    from marie_tpu_torch.document.trocr_ocr_processor import TrOcrProcessor
    from marie_tpu_torch.models.configs import TrOCRConfig
    from marie_tpu_torch.registry.convert import init_flax_layout

    params = init_flax_layout(TrOCRConfig.tiny(), 3)
    page = _ink_page(4, 1024, 768, n_words=60)
    rng = np.random.default_rng(5)
    n = 259
    xywh = np.stack([rng.uniform(0, 700, n), rng.uniform(0, 980, n),
                     rng.uniform(6, 68, n), rng.uniform(8, 44, n)], -1).round()
    xywh[7] = (40, 100, 300, 700)  # taller than the Pallas window
    results = []
    for dev in (cuda_device, torch.device("cpu")):
        op = TrOcrProcessor(TrOCRConfig.tiny(), params, batch_sizes=(32, 128, 256),
                            device=dev)
        fut = op.recognize_dispatch(torch.from_numpy(page).to(dev), xywh, 1.0)
        assert [t.shape[0] for _, t, _ in fut] == [256, 32]
        results.append(op.recognize_collect(fut))
    got, want = results
    assert [w["text"] for w in got] == [w["text"] for w in want]
    np.testing.assert_allclose([w["confidence"] for w in got],
                               [w["confidence"] for w in want], rtol=0, atol=1e-3)


@pytest.mark.cuda
def test_cuda_stream_returns_groups_in_order(cuda_device):
    """fused_dispatch_stream with max_in_flight=1 on the card yields the
    groups in page order, each with an event that its results wait on,
    and their collect equals the CPU run's."""
    from marie_tpu_torch.boxes.craft_box_processor import BoxProcessorCraft
    from marie_tpu_torch.document.trocr_ocr_processor import TrOcrProcessor
    from marie_tpu_torch.enums import PSMode
    from marie_tpu_torch.models.configs import CraftConfig, TrOCRConfig
    from marie_tpu_torch.ocr import fused
    from marie_tpu_torch.preprocess.buckets import BucketSpec
    from marie_tpu_torch.registry.convert import init_flax_layout

    trees = (init_flax_layout(CraftConfig.tiny(), 1), init_flax_layout(TrOCRConfig.tiny(), 2))
    pages = [_ink_page(10 + s, 256, 384, n_words=8) for s in range(5)]
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        bp = BoxProcessorCraft(CraftConfig.tiny(), trees[0], box_source="ink",
                               max_components=64, min_area=4, device=dev,
                               bucket_spec=BucketSpec(shapes=((256, 384),)))
        op = TrOcrProcessor(TrOCRConfig.tiny(), trees[1], device=dev)
        handles = list(fused.fused_dispatch_stream(
            bp, op, pages, page_batch=2, compact_slots=4, max_in_flight=1,
            upload_format="u2"))
        assert [fused.handle_page_count(h) for h in handles] == [2, 2, 1]
        assert all((h.ready is not None) == (dev.type == "cuda") for h in handles)
        pages_out = fused.fused_collect_many(bp, op, handles, [PSMode.SPARSE] * 5)
        out.append([(p[0].tolist(), [w["text"] for w in p[4]]) for p in pages_out])
    assert out[0] == out[1] and sum(len(t) for _, t in out[0]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,s,kv_min", [
    (16, 4, 192, 1),  # the chain heads: 16 pages, synth width, cap 192
    (16, 12, 708, 197),  # the base classifier: 512 tokens + 196 patches
    (7, 12, 512, 1),  # the base indexer: 7 windows of 512
])
def test_cuda_attention_fp32_head_shapes(cuda_device, b, h, s, kv_min):
    """K2 in float32 with kv_len at the LayoutLM heads' shapes, on the
    projections' strided views, within 1e-4 of its plain version."""
    g = torch.Generator(device="cuda").manual_seed(2)

    def make():
        return torch.randn(b, s, h, 64, device=cuda_device, generator=g).transpose(1, 2)

    q, k, v = make(), make(), make()
    kv_len = torch.randint(kv_min, s + 1, (b,), device=cuda_device, generator=g).to(torch.int32)
    before = k2.flash_attention.launches
    got = k2.flash_attention(q, k, v, kv_len=kv_len)
    want = k2.attention_reference(q, k, v, kv_len=kv_len, sm_scale=1.0 / 8.0)
    torch.cuda.synchronize()
    assert k2.flash_attention.launches == before + 1
    assert float((got - want).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "projections"])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("sq,skv,causal,kv_len", [
    (708, 708, False, [1, 63, 64, 65, 708, 0]),  # around tile edges, and no key
    (150, 70, True, None),  # causal Sq > Skv: rows 0-79 see no key
    (150, 70, True, [70, 0, 33]),
    (45, 708, True, [708, 64, 0, 65]),  # Sq < Skv: the diagonal cuts tiles
])
def test_cuda_attention_fp32_skipped_tiles(cuda_device, d, sq, skv, causal, kv_len, layout):
    """Float32 K2 where it skips key tiles past kv_len and above the
    causal diagonal: within 1e-4 of its plain version in one launch, and a
    row with no valid key (kv_len 0, or causal rows above the diagonal
    when Sq > Skv) is the uniform average of V over all of Skv."""
    g = torch.Generator(device="cuda").manual_seed(3)
    b, h = (len(kv_len) if kv_len else 2), 3

    def make(s):
        x = torch.randn(b, s, h, d, device=cuda_device, generator=g)
        return x.transpose(1, 2) if layout == "projections" else x.transpose(1, 2).contiguous()

    q, k, v = make(sq), make(skv), make(skv)
    kvl = (torch.tensor(kv_len, dtype=torch.int32, device=cuda_device)
           if kv_len else None)
    before = k2.flash_attention.launches
    got = k2.flash_attention(q, k, v, kv_len=kvl, causal=causal)
    want = k2.attention_reference(q, k, v, causal=causal, kv_len=kvl, sm_scale=1.0 / d ** 0.5)
    torch.cuda.synchronize()
    assert k2.flash_attention.launches == before + 1
    assert float((got - want).abs().max()) <= 1e-4
    mean_v = v.mean(dim=2, keepdim=True)  # [B, H, 1, D]
    blind = torch.zeros(b, sq, dtype=torch.bool, device=cuda_device)
    if kvl is not None:
        blind |= (kvl == 0)[:, None]
    if causal:
        blind[:, :max(sq - skv, 0)] = True
    assert blind.any() == (sq > skv or (kv_len is not None and 0 in kv_len))
    for bi, rows in enumerate(blind):
        if rows.any():
            err = (got[bi][:, rows] - mean_v[bi]).abs().max()
            assert float(err) <= 1e-4


@pytest.mark.cuda
def test_cuda_chained_engine_matches_cpu(cuda_device):
    """PipelineOcrEngine with chained heads on the card equals the CPU
    run's result dicts (classification label ids, NER label ids; scores
    within 1e-3), with rows past the budget and words past the cap."""
    import dataclasses

    from marie_tpu_torch.boxes.craft_box_processor import BoxProcessorCraft
    from marie_tpu_torch.components.document_classifier import LayoutDocumentClassifier
    from marie_tpu_torch.components.document_indexer import LayoutDocumentIndexer
    from marie_tpu_torch.components.word_tokenizer import RollingWordTokenizer
    from marie_tpu_torch.document.trocr_ocr_processor import TrOcrProcessor
    from marie_tpu_torch.models.configs import CraftConfig, LayoutLMConfig, TrOCRConfig
    from marie_tpu_torch.ocr.ocr_engine import PipelineOcrEngine
    from marie_tpu_torch.preprocess.buckets import BucketSpec
    from marie_tpu_torch.registry.convert import init_flax_layout

    trees = (init_flax_layout(CraftConfig.tiny(), 1), init_flax_layout(TrOCRConfig.tiny(), 2))
    head_cfg = dataclasses.replace(LayoutLMConfig.tiny(3), use_image=False, max_seq_len=6,
                                   vocab_size=512)
    ner_cfg = dataclasses.replace(head_cfg, num_labels=5)
    head_trees = (init_flax_layout(head_cfg, 3, "sequence"), init_flax_layout(ner_cfg, 4, "token"))
    pages = [_ink_page(20 + s, 256, 384, n_words=10) for s in range(3)]
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        bp = BoxProcessorCraft(CraftConfig.tiny(), trees[0], box_source="ink",
                               max_components=64, min_area=4, device=dev,
                               bucket_spec=BucketSpec(shapes=((256, 384),)))
        op = TrOcrProcessor(TrOCRConfig.tiny(), trees[1], device=dev)
        cls = LayoutDocumentClassifier(("a", "b", "c"), head_cfg, head_trees[0],
                                       tokenizer=RollingWordTokenizer(512), device=dev)
        ner = LayoutDocumentIndexer(("O", "B-K", "I-K", "B-V", "I-V"), ner_cfg, head_trees[1],
                                    tokenizer=RollingWordTokenizer(512), device=dev)
        out.append(PipelineOcrEngine(bp, op, page_fuse_batch=2, compact_slots=6,
                                     classifier=cls, indexer=ner).extract(pages))
    got, want = out

    def split(results):
        plain, scores = [], []
        for r in results:
            scores += [r["classification"]["score"]] + [
                x for w in r["words"] for x in (w["confidence"], w.get("ner_score", -1.0))]
            plain.append(dict(r, classification=dict(r["classification"], score=None),
                              words=[dict(w, confidence=None, ner_score=None)
                                     for w in r["words"]],
                              lines=[dict(ln, confidence=None) for ln in r["lines"]]))
        return plain, np.asarray(scores)

    (g, gs), (w, ws) = split(got), split(want)
    assert g == w
    np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-3)
    labelled = sum(1 for r in want for wd in r["words"] if "ner_label" in wd)
    assert 0 < labelled < sum(len(r["words"]) for r in want)


@pytest.mark.cuda
def test_cuda_fragments_path_launches_k2(cuda_device):
    """Host fragments (WORD / RAW_LINE / MULTI_LINE, regions) decode on the
    card with K2 counted on the "fragments" path, and equal the CPU."""
    from marie_tpu_torch.document.trocr_ocr_processor import TrOcrProcessor
    from marie_tpu_torch.models.configs import TrOCRConfig
    from marie_tpu_torch.ops.kernels import _build
    from marie_tpu_torch.registry.convert import init_flax_layout

    params = init_flax_layout(TrOCRConfig.tiny(), 6)
    page = _ink_page(7, 256, 384, n_words=12)
    rng = np.random.default_rng(8)
    frags = []
    for i in range(40):
        fh, fw = int(rng.integers(8, 60)), int(rng.integers(6, 300))
        y, x = int(rng.integers(0, 256 - fh)), int(rng.integers(0, 384 - fw))
        frag = page[y:y + fh, x:x + fw]
        frags.append(np.stack([frag, frag // 2, 255 - frag], -1) if i % 4 == 0 else frag)
    results = []
    for dev in (cuda_device, torch.device("cpu")):
        op = TrOcrProcessor(TrOCRConfig.tiny(), params, batch_sizes=(8, 32), device=dev)
        _build.reset_counts(k2.flash_attention)
        results.append(op.recognize_from_fragments(frags))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert k2.flash_attention.launches_by_path.get("fragments", 0) > 0
            assert k2.flash_attention.launches == k2.flash_attention.launches_by_path["fragments"]
    got, want = results
    assert [w["text"] for w in got] == [w["text"] for w in want]
    np.testing.assert_allclose([w["confidence"] for w in got],
                               [w["confidence"] for w in want], rtol=0, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("single_program", [True, False])
def test_cuda_oversize_and_rgb_pages_match_cpu(cuda_device, single_program):
    """A page over the largest bucket (scaled into it on the host) and an
    RGB page with distinct channels (cropped with stock ops on the card),
    card against CPU: equal result dicts, confidences within 1e-3."""
    from marie_tpu_torch.boxes.craft_box_processor import BoxProcessorCraft
    from marie_tpu_torch.document.trocr_ocr_processor import TrOcrProcessor
    from marie_tpu_torch.models.configs import CraftConfig, TrOCRConfig
    from marie_tpu_torch.ocr.ocr_engine import PipelineOcrEngine
    from marie_tpu_torch.preprocess.buckets import BucketSpec
    from marie_tpu_torch.registry.convert import init_flax_layout

    trees = (init_flax_layout(CraftConfig.tiny(), 3), init_flax_layout(TrOCRConfig.tiny(), 4))
    big = _ink_page(20, 700, 384, n_words=30)  # over the 512x384 bucket: x 0.73
    gray = _ink_page(21, 256, 384, n_words=10)
    rgb = np.stack([gray, np.clip(gray.astype(int) + 40, 0, 255).astype(np.uint8),
                    255 - (255 - gray) // 2], -1)
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        bp = BoxProcessorCraft(CraftConfig.tiny(), trees[0], box_source="ink",
                               max_components=64, min_area=4, device=dev,
                               bucket_spec=BucketSpec(shapes=((256, 384), (512, 384))))
        op = TrOcrProcessor(TrOCRConfig.tiny(), trees[1], batch_sizes=(8, 32), device=dev)
        engine = PipelineOcrEngine(bp, op, single_program=single_program,
                                   page_fuse_batch=2, compact_slots=6)
        out.append(engine.extract([big, rgb, rgb]))
        if dev.type == "cuda":
            torch.cuda.synchronize()
    got, want = out

    def strip(results):
        return [dict(r, words=[dict(w, confidence=None) for w in r["words"]],
                     lines=[dict(ln, confidence=None) for ln in r["lines"]]) for r in results]

    assert strip(got) == strip(want) and sum(len(r["words"]) for r in got) > 12
    np.testing.assert_allclose([w["confidence"] for r in got for w in r["words"]],
                               [w["confidence"] for r in want for w in r["words"]],
                               rtol=0, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [128, 1, 300])
@pytest.mark.parametrize("out_hw", [(32, 256), (32, 64), (20, 77)])
def test_cuda_crop_kernel_channel_mean_matches_plain(cuda_device, out_hw, n):
    """K1's channel mean (the CRNN's crops, 32x256 in the best engine)
    is bit-identical to its plain version (limit 0)."""
    pages, pidx, boxes = _crop_case(6, 2, 1024, 768, n)
    args = (torch.from_numpy(pages).to(cuda_device), torch.from_numpy(pidx).to(cuda_device),
            torch.from_numpy(boxes).to(cuda_device), *out_hw, True)
    got, got_w = k1.crop_resize(*args)
    want, want_w = k1.crop_resize_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got_w, want_w)
    assert not torch.equal(got, k1.crop_resize(*args[:-1])[0])


@pytest.mark.cuda
@pytest.mark.parametrize("beam_size", [1, 5])
def test_cuda_beam_decode_matches_cpu(cuda_device, beam_size):
    """TrOCR beam search on the card (K2 in the encoder) equals the CPU's
    in float32: tokens and lengths, confidences within 1e-4."""
    from marie_tpu_torch.models.configs import TrOCRConfig
    from marie_tpu_torch.models.trocr import beam_decode
    from marie_tpu_torch.registry.convert import init_flax_layout, load_model

    cfg = TrOCRConfig.tiny()
    tree = init_flax_layout(cfg, 9)
    tree["params"]["decoder"]["lm_head"]["kernel"][:, cfg.decoder.eos_id] *= 2.0
    crops = torch.from_numpy(np.random.default_rng(9).random(
        (16, *cfg.encoder.image_size, 3)).astype(np.float32))
    out = [beam_decode(load_model(cfg, tree, device=dev), crops.to(dev), beam_size)
           for dev in (cuda_device, torch.device("cpu"))]
    (gt, gl, gc), (wt, wl, wc) = [[x.cpu() for x in o] for o in out]
    assert torch.equal(gt, wt) and torch.equal(gl, wl)
    assert float((gc - wc).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["tiny", "default"])
def test_cuda_crnn_matches_cpu(cuda_device, preset):
    """The CRNN (cuDNN convolutions and LSTMs, float32 with TF32 off)
    on the card against the CPU: logits within 1e-4, and the global TF32
    switches do not move the processor's result."""
    from marie_tpu_torch.document.crnn_ocr_processor import CrnnOcrProcessor
    from marie_tpu_torch.models.configs import CRNNConfig
    from marie_tpu_torch.registry.convert import init_flax_layout
    from marie_tpu_torch.utils.device import _precision_flags, float32_precision

    cfg = CRNNConfig.tiny() if preset == "tiny" else CRNNConfig()
    tree = init_flax_layout(cfg, 4)
    x = torch.from_numpy(np.random.default_rng(4).random((8, 32, 256, 1)).astype(np.float32))
    procs = [CrnnOcrProcessor(cfg, tree, device=dev) for dev in (cuda_device, "cpu")]
    with torch.no_grad(), float32_precision(allow_tf32=False):
        got = procs[0].model(x.to(cuda_device)).cpu()
    with torch.no_grad():
        want = procs[1].model(x)
    assert float((got - want).abs().max()) <= 1e-4
    page = torch.from_numpy(_ink_page(3, 256, 384, n_words=12))
    boxes = np.asarray([[8, 8, 120, 24], [100, 60, 200, 30], [0, 200, 384, 40]], np.float32)
    read, write, n = _precision_flags()
    start = read()
    try:
        write(("tf32",) * n)
        on = procs[0].recognize_from_page(page.to(cuda_device), boxes)
        write(("ieee",) * n)
        off = procs[0].recognize_from_page(page.to(cuda_device), boxes)
    finally:
        write(start)
    assert on == off


@pytest.mark.cuda
def test_cuda_best_engine_matches_cpu_and_launches_on_best(cuda_device):
    """The voting engine (ink CRAFT, TrOCR beam-5, CRNN; tiny, float32)
    on the card against the CPU: equal result dicts, confidences within
    1e-3; K1 and K2 launch on the "best" path (WORD mode's TrOCR
    fragments count on "fragments")."""
    from marie_tpu_torch.boxes.craft_box_processor import BoxProcessorCraft
    from marie_tpu_torch.document.crnn_ocr_processor import CrnnOcrProcessor
    from marie_tpu_torch.document.trocr_ocr_processor import TrOcrProcessor
    from marie_tpu_torch.enums import PSMode
    from marie_tpu_torch.models.configs import CraftConfig, CRNNConfig, TrOCRConfig
    from marie_tpu_torch.ocr.voting_ocr_engine import VotingOcrEngine
    from marie_tpu_torch.ops.kernels import _build
    from marie_tpu_torch.preprocess.buckets import BucketSpec
    from marie_tpu_torch.registry.convert import init_flax_layout

    trees = [init_flax_layout(c, 5 + i) for i, c in enumerate(
        (CraftConfig.tiny(), TrOCRConfig.tiny(), CRNNConfig.tiny()))]
    gray = _ink_page(30, 256, 384, n_words=14)
    rgb = np.stack([gray, gray // 2, 255 - (255 - gray) // 3], -1)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        bp = BoxProcessorCraft(CraftConfig.tiny(), trees[0], box_source="ink", min_area=4,
                               max_components=64, device=dev,
                               bucket_spec=BucketSpec(shapes=((256, 384),)))
        engine = VotingOcrEngine(bp, [
            TrOcrProcessor(TrOCRConfig.tiny(), trees[1], beam_size=5, batch_sizes=(8, 32),
                           device=dev),
            CrnnOcrProcessor(CRNNConfig.tiny(), trees[2], batch_sizes=(8, 32), device=dev)])
        _build.reset_counts(k1.crop_resize, k2.flash_attention)
        out[dev.type] = (engine.extract([gray, rgb]),
                         engine.extract([gray[20:60, 10:200]], PSMode.WORD))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert k1.crop_resize.launches_by_path.get("best", 0) > 0
            assert k2.flash_attention.launches_by_path.get("best", 0) > 0
    for got, want in zip(out["cuda"], out["cpu"]):
        strip = [[dict(r, words=[dict(w, confidence=None) for w in r["words"]],
                       lines=[dict(ln, confidence=None) for ln in r["lines"]]) for r in rs]
                 for rs in (got, want)]
        assert strip[0] == strip[1]
        np.testing.assert_allclose([w["confidence"] for r in got for w in r["words"]],
                                   [w["confidence"] for r in want for w in r["words"]],
                                   rtol=0, atol=1e-3)
    assert sum(len(r["words"]) for r in out["cpu"][0]) > 8


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1024, 768), (3300, 2550, 3), (100, 37, 3)])
def test_cuda_classifier_page_image_equals_cpu(cuda_device, shape):
    """The classifier's page image on the card equals the CPU's to the bit:
    the same host resize, and a true division by 255 on both (a division
    by a CPU scalar would be a multiply by its reciprocal on the card)."""
    from marie_tpu_torch.components.document_classifier.layoutlm_classifier import (
        resize_page_image,
    )

    img = np.random.default_rng(3).integers(0, 256, shape).astype(np.uint8)
    got = resize_page_image(img, (224, 224), cuda_device).cpu()
    want = resize_page_image(img, (224, 224), torch.device("cpu"))
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_layout_embeddings_match_cpu_and_launch_on_embeddings(cuda_device):
    """LayoutEmbeddingsModel at tiny width, card against CPU within 1e-4;
    K2 launches once per layer on the ``"embeddings"`` path."""
    import dataclasses

    from marie_tpu_torch.embeddings import LayoutEmbeddingsModel
    from marie_tpu_torch.models.configs import LayoutLMConfig
    from marie_tpu_torch.registry.convert import init_flax_layout

    config = LayoutLMConfig.tiny()
    tree = init_flax_layout(dataclasses.replace(config, use_image=False), 3, "encoder")
    texts = ["invoice total amount", "patient claim form due 12/01/2023", "", "word " * 90]
    before = k2.flash_attention.launches_by_path.get("embeddings", 0)
    got = LayoutEmbeddingsModel(config, tree, device="cuda").get_embeddings(texts)
    torch.cuda.synchronize()
    launches = k2.flash_attention.launches_by_path.get("embeddings", 0) - before
    want = LayoutEmbeddingsModel(config, tree, device="cpu").get_embeddings(texts)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert launches == config.num_layers


@pytest.mark.cuda
def test_cuda_overlay_matches_cpu(cuda_device):
    """The seeded ``synth``-width generator in float32 ``segment_batch`` at
    ``gan_scale`` 1 and 2, card against CPU: masks and blended pixels
    equal in >= 99.9% (a float32 value on a rounding boundary of
    ``clip((fake + 1) * 127.5)`` moves a pixel by one level), never more
    than one level apart where the masks agree; bfloat16 on the card
    runs and agrees with float32 on >= 99% of the masks."""
    from marie_tpu_torch.models.configs import Pix2PixConfig
    from marie_tpu_torch.overlay.overlay import OverlayProcessor, _segment_batch_gray
    from marie_tpu_torch.registry.convert import init_flax_layout

    tree = init_flax_layout(Pix2PixConfig.synth(), 6)
    pages = np.stack([_ink_page(40 + s, 256, 192, n_words=8) for s in range(2)])
    pages[:, 60:64, :] = np.minimum(pages[:, 60:64, :], 160)  # a form rule
    procs = [OverlayProcessor(config=Pix2PixConfig.synth(), variables=tree, device=dev)
             for dev in (cuda_device, torch.device("cpu"))]
    for gan_scale in (1, 2):
        (m, b), (mc, bc) = [
            [t.cpu().numpy() for t in p._forward(_segment_batch_gray, "float32",
                                                  torch.from_numpy(pages).to(p.device),
                                                  gan_scale)]
            for p in procs]
        d = np.abs(b.astype(np.int16) - bc)
        assert np.mean(m == mc) >= 0.999 and np.mean(d == 0) >= 0.999
        assert d[m == mc].max() <= 1
        m16, _ = procs[0]._forward(_segment_batch_gray, "bfloat16",
                                   torch.from_numpy(pages).to(cuda_device), gan_scale)
        assert np.mean(m16.cpu().numpy() == m) >= 0.99


@pytest.mark.cuda
def test_cuda_extract_pipeline_matches_cpu(cuda_device, tmp_path):
    """``ExtractPipeline`` with a tiny engine, tiny heads and the tiny
    generator (float32) on the card against the CPU run, on a clean page
    and a dirty one: the dirty page's cleaned image within the overlay
    test's limits; the clean page's OCR result dict (confidences within
    1e-3), label and entities (scores within 1e-3) equal; the same asset
    listing; K1 and K2 launch on the card.  (The dirty page's OCR reads
    the generator's output, where a pixel one level off may move an ink
    box, so it is not compared.)"""
    import json

    import chip_smoke
    from marie_tpu_torch.boxes.craft_box_processor import BoxProcessorCraft
    from marie_tpu_torch.components.document_classifier import LayoutDocumentClassifier
    from marie_tpu_torch.components.document_indexer import LayoutDocumentIndexer
    from marie_tpu_torch.document.trocr_ocr_processor import TrOcrProcessor
    from marie_tpu_torch.models.configs import (
        CraftConfig,
        LayoutLMConfig,
        Pix2PixConfig,
        TrOCRConfig,
    )
    from marie_tpu_torch.ocr.ocr_engine import PipelineOcrEngine
    from marie_tpu_torch.ops.kernels import _build
    from marie_tpu_torch.overlay.overlay import OverlayProcessor
    from marie_tpu_torch.pipe import ExtractPipeline
    from marie_tpu_torch.registry.convert import init_flax_layout
    from marie_tpu_torch.utils.image_io import read_png

    trees = {"craft": init_flax_layout(CraftConfig.tiny(), 1),
             "trocr": init_flax_layout(TrOCRConfig.tiny(), 2),
             "cls": init_flax_layout(LayoutLMConfig.tiny(3), 3, "sequence"),
             "ner": init_flax_layout(LayoutLMConfig.tiny(3), 4, "token"),
             "gen": init_flax_layout(Pix2PixConfig.tiny(), 5)}
    frames = [_ink_page(50 + s, 192, 256, n_words=8) for s in range(2)]
    frames[1] = chip_smoke.dirty_pages([frames[1]], seed=3)[0]
    runs = []
    for dev in (cuda_device, torch.device("cpu")):
        _build.reset_counts(k1.crop_resize, k2.flash_attention)
        engine = PipelineOcrEngine(
            BoxProcessorCraft(CraftConfig.tiny(), trees["craft"], box_source="ink",
                              max_components=64, min_area=4, device=dev),
            TrOcrProcessor(TrOCRConfig.tiny(), trees["trocr"], device=dev))
        pipe = ExtractPipeline(
            ocr_engine=engine,
            classifiers=[LayoutDocumentClassifier(("a", "b", "c"), LayoutLMConfig.tiny(3),
                                                  trees["cls"], device=dev)],
            indexers=[LayoutDocumentIndexer(("O", "B-K", "I-K"), LayoutLMConfig.tiny(3),
                                            trees["ner"], window=16, stride=8, device=dev)],
            overlay_processor=OverlayProcessor(config=Pix2PixConfig.tiny(),
                                               variables=trees["gen"],
                                               compute_dtype="float32", device=dev),
            work_dir=str(tmp_path / dev.type), device=dev)
        meta = json.loads(json.dumps(pipe.execute("doc.tif", "extract", frames)))
        (checksum,) = os.listdir(tmp_path / dev.type)
        root = tmp_path / dev.type / checksum
        runs.append((meta, read_png(str(root / "clean" / "doc_00001.png")),
                     sorted(os.path.relpath(os.path.join(b, f), root)
                            for b, _, fs in os.walk(root) for f in fs),
                     k1.crop_resize.launches, k2.flash_attention.launches))
    (got, got_clean, got_assets, k1_n, k2_n), (want, want_clean, want_assets, _, _) = runs
    assert k1_n > 0 and k2_n > 0
    d = np.abs(got_clean.astype(np.int16) - want_clean)
    assert np.mean(d == 0) >= 0.999 and not np.array_equal(got_clean, frames[1])
    assert got_assets == want_assets

    def split(obj):
        if isinstance(obj, dict):
            return {k: split(v) for k, v in obj.items()}
        if isinstance(obj, list):
            return [split(v) for v in obj]
        return None if isinstance(obj, float) else obj

    def floats(obj):
        if isinstance(obj, dict):
            return [x for _, v in sorted(obj.items()) for x in floats(v)]
        if isinstance(obj, list):
            return [x for v in obj for x in floats(v)]
        return [obj] if isinstance(obj, float) else []

    for key in ("ocr", "page_classifier", "page_indexer"):
        assert split(got[key][0]) == split(want[key][0])
        np.testing.assert_allclose(floats(got[key][0]), floats(want[key][0]), rtol=0, atol=1e-3)


def _registered_inputs():
    from marie_tpu_torch.components.document_registration.boundary import rotate_page
    from marie_tpu_torch.registry.zoo import ZOO_DIR

    with np.load(os.path.join(ZOO_DIR, "pages.npz")) as data:
        pages = [data["pages"][i] for i in (0, 1)]
    return pages, [rotate_page(torch.from_numpy(np.stack([p] * 3, -1)),
                               np.float32(np.radians(a))).numpy()
                   for p, a in zip(pages, (2.3, -4.1))]


@pytest.mark.cuda
@pytest.mark.parametrize("use_model", [False, True])
def test_cuda_registration_matches_cpu(cuda_device, use_model):
    """Both registration paths on the card against the CPU path: box,
    angle and detection equal, scores within 1e-4; the deskewed pages
    equal (the same emulated fused multiply-adds on both); the model
    path's warped pages equal on >= 95% of pixels and more than 1 level
    apart on <= 1% (the network's float32 corners differ by ~1e-7 and
    the seeded regressor's small quad magnifies: measured 99.07%, 0.93%
    off by up to 7)."""
    from marie_tpu_torch.components.document_registration import (
        DocumentBoundaryRegistration,
    )

    _, pages = _registered_inputs()
    card = DocumentBoundaryRegistration(use_model=use_model, device="cuda")
    cpu = DocumentBoundaryRegistration(use_model=use_model, device="cpu")
    for page in pages:
        got, want = card.register(page), cpu.register(page)
        g, w = got.to_dict(), want.to_dict()
        assert abs(g.pop("score") - w.pop("score")) <= 1e-4
        assert g == w
        if not use_model:
            np.testing.assert_array_equal(got.aligned, want.aligned)
            continue
        d = np.abs(got.aligned.astype(np.int16) - want.aligned)
        assert np.mean(d == 0) >= 0.95 and np.mean(d > 1) <= 0.01


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["NCCTemplateMatcher", "DIMTemplateMatcher",
                                  "VQNNFTemplateMatcher"])
def test_cuda_matchers_match_cpu(cuda_device, name):
    """Each matcher on the card against the CPU on two shipped pages and
    word crops: the same matches, scores within 1e-3."""
    import json

    from marie_tpu_torch.components import template_matching as tm
    from marie_tpu_torch.registry.zoo import ZOO_DIR

    pages, _ = _registered_inputs()
    with open(os.path.join(ZOO_DIR, "truth.json")) as f:
        truth = json.load(f)["pages"][0]
    card, cpu = getattr(tm, name)(device="cuda"), getattr(tm, name)(device="cpu")
    for k, (_, (x, y, w, h)) in enumerate(truth[:3]):
        for m in (card, cpu):
            m.add_template(f"w{k}", pages[0][y:y + h, x:x + w])
    got, want = card.match(pages, score_threshold=0.5), cpu.match(pages, score_threshold=0.5)
    assert got
    assert [(m.frame_index, m.label, m.bbox) for m in got] == [
        (m.frame_index, m.label, m.bbox) for m in want]
    assert max(abs(a.score - b.score) for a, b in zip(got, want)) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,s", [(1, 4, 768), (1, 6, 3072)], ids=["dit_s1", "dit_default"])
def test_cuda_attention_at_dit_shapes_matches_plain(cuda_device, b, h, s):
    """K2 float32 at the DiT encoder's shapes (one page: 768 tokens at
    ``dit_synth_s1``, 3,072 at the no-tree default; D=64) on the
    projections' layout, within 1e-4 of its plain version."""
    g = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = (torch.randn(b, s, h, 64, device=cuda_device, generator=g).transpose(1, 2)
               for _ in range(3))
    got = k2.flash_attention(q, k, v)
    want = k2.attention_reference(q, k, v, sm_scale=1.0 / 8.0)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-4


def _shipped_pages(n):
    from marie_tpu_torch.registry.zoo import ZOO_DIR

    with np.load(os.path.join(ZOO_DIR, "pages.npz")) as data:
        return [np.stack([p] * 3, axis=-1) for p in data["pages"][:n]]


@pytest.mark.cuda
def test_cuda_ink_detector_matches_cpu(cuda_device):
    """The weight-free ink detector: the same boxes on the card as on the
    CPU (Otsu, the closing and the components are exact)."""
    from marie_tpu_torch.boxes import InkBoxProcessor

    card, cpu = InkBoxProcessor(device="cuda"), InkBoxProcessor(device="cpu")
    for page in _shipped_pages(2):
        got, want = card.detect_words(page), cpu.detect_words(page)
        assert len(want[0]) > 10
        np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.cuda
def test_cuda_dit_detector_matches_cpu_and_launches_on_detectors(cuda_device):
    """DiT at ``dit_synth_s1`` width from a seed: the heatmap within 1e-4
    of the CPU's (float32, TF32 kept out), K2 launched 6 times a page on
    the ``"detectors"`` path."""
    from marie_tpu_torch.boxes import BoxProcessorUlimDit
    from marie_tpu_torch.boxes.box_processor import fit_page
    from marie_tpu_torch.boxes.dit_box_processor import dit_heatmap
    from marie_tpu_torch.models.configs import ViTConfig
    from marie_tpu_torch.registry.convert import init_flax_layout

    cfg = ViTConfig.dit_synth_s1()
    tree = init_flax_layout(cfg, 0)
    card = BoxProcessorUlimDit(config=cfg, variables=tree, device="cuda")
    cpu = BoxProcessorUlimDit(config=cfg, variables=tree, device="cpu")
    page = _shipped_pages(1)[0]
    before = dict(k2.flash_attention.launches_by_path)
    got = dit_heatmap(card.model, fit_page(page, card.buckets, "cuda")[0]).cpu()
    want = dit_heatmap(cpu.model, fit_page(page, cpu.buckets, "cpu")[0])
    torch.cuda.synchronize()
    after = k2.flash_attention.launches_by_path
    assert after.get("detectors", 0) - before.get("detectors", 0) == cfg.num_layers
    assert float((got - want).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_cuda_textfusenet_matches_cpu(cuda_device):
    """TextFuseNet at ``synth_s2`` from a seed: dense maps within 1e-4 of
    the CPU's."""
    from marie_tpu_torch.boxes import BoxProcessorTextFuseNet
    from marie_tpu_torch.boxes.box_processor import fit_page
    from marie_tpu_torch.models.configs import TextFuseNetConfig
    from marie_tpu_torch.preprocess.ops import normalize_page
    from marie_tpu_torch.registry.convert import init_flax_layout
    from marie_tpu_torch.utils.device import float32_precision

    cfg = TextFuseNetConfig.synth_s2()
    tree = init_flax_layout(cfg, 0)
    outs = []
    for dev in ("cuda", "cpu"):
        bp = BoxProcessorTextFuseNet(config=cfg, variables=tree, device=dev)
        with torch.no_grad(), float32_precision(False):
            page = fit_page(_shipped_pages(1)[0], bp.buckets, dev)[0]
            out = bp.model.dense(normalize_page(page)[None])
        outs.append({k: v.cpu() for k, v in out.items()})
    for key in outs[1]:
        assert float((outs[0][key] - outs[1][key]).abs().max()) <= 1e-4, key


@pytest.mark.cuda
@pytest.mark.parametrize("cc_stats", ["reduce", "reduce2", "runs", "sort"])
def test_cuda_cc_stats_variants_equal_runs_cc(cuda_device, cc_stats):
    """Each stats variant on the card gives ``runs_cc``'s stats on random
    masks with non-negative scores."""
    from marie_tpu_torch.boxes.craft_box_processor import cc_component_stats

    g = torch.Generator(device="cuda").manual_seed(3)
    mask = torch.rand(4, 96, 128, device=cuda_device, generator=g) < 0.3
    scores = torch.rand(4, 96, 128, device=cuda_device, generator=g)
    want = cc_component_stats(mask, scores, 256, "runs_cc")
    got = cc_component_stats(mask, scores, 256, cc_stats)
    for key in want:
        assert torch.equal(got[key], want[key]), key


@pytest.mark.cuda
def test_cuda_attention_at_the_reading_order_shape(cuda_device):
    """K2 float32 at D=32 (the reading-order model at base width: 4
    heads, 256 boxes, ``kv_len`` a page's box count), within 1e-4 of its
    plain version."""
    g = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (torch.randn(1, 256, 4, 32, device=cuda_device, generator=g).transpose(1, 2)
               for _ in range(3))
    kv_len = torch.tensor([138], dtype=torch.int32, device=cuda_device)
    got = k2.flash_attention(q, k, v, kv_len=kv_len)
    want = k2.attention_reference(q, k, v, kv_len=kv_len, sm_scale=32 ** -0.5)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_cuda_reading_order_matches_cpu_and_launches(cuda_device):
    """The seeded base-width reading-order model orders a 600-box page
    (three bands) on the card as on the CPU (scores within 1e-4), with
    K2 launched 4 times a band on ``"reading_order"``."""
    import chip_smoke as cs
    from marie_tpu_torch.models.reading_order import ReadingOrderConfig, TextLayout
    from marie_tpu_torch.ops.kernels import _build
    from marie_tpu_torch.registry.convert import init_flax_layout

    tree = init_flax_layout(ReadingOrderConfig.base(), cs.READING_ORDER_SEED)
    card = TextLayout(ReadingOrderConfig.base(), tree, device="cuda")
    cpu = TextLayout(ReadingOrderConfig.base(), tree, device="cpu")
    boxes = cs.long_page_boxes()
    _build.reset_counts(k2.flash_attention)
    got, got_scores = card.order_and_scores(boxes, 1024.0)
    want, want_scores = cpu.order_and_scores(boxes, 1024.0)
    assert float(np.abs(got_scores - want_scores).max()) <= 1e-4
    from marie_tpu_torch.check import order_swaps

    assert order_swaps(got, want, want_scores, 2e-4) <= 2
    assert k2.flash_attention.launches_by_path.get("reading_order") == 12


@pytest.mark.cuda
def test_cuda_rotated_ops_match_cpu(cuda_device):
    """The rotated IoU, rotated NMS, rotated ROIAlign and deformable
    convolution on the card within 1e-5 of the CPU port."""
    from marie_tpu_torch.ops.deform_conv import deform_conv2d
    from marie_tpu_torch.ops.nms import rotated_nms
    from marie_tpu_torch.ops.roi_align import roi_align_rotated
    from marie_tpu_torch.ops.rotated_iou import pairwise_rotated_iou

    rng = np.random.default_rng(4)
    boxes = np.concatenate([rng.uniform(0, 200, (64, 2)), rng.uniform(4, 40, (64, 2)),
                            rng.choice([0.0, 45.0, 90.0, -30.0], (64, 1))], 1).astype(
        np.float32)
    scores = rng.random(64).astype(np.float32)
    np.testing.assert_allclose(pairwise_rotated_iou(boxes, boxes, device="cuda").cpu().numpy(),
                               pairwise_rotated_iou(boxes, boxes, device="cpu").numpy(),
                               atol=1e-5)
    keep_card, _ = rotated_nms(boxes, scores, 0.3, device="cuda")
    keep_cpu, _ = rotated_nms(boxes, scores, 0.3, device="cpu")
    assert torch.equal(keep_card.cpu(), keep_cpu)
    feats = rng.standard_normal((2, 8, 40, 40)).astype(np.float32)
    rois = np.concatenate([rng.integers(0, 2, (16, 1)), rng.uniform(0, 40, (16, 2)),
                           rng.uniform(2, 20, (16, 2)), rng.uniform(-90, 90, (16, 1))],
                          1).astype(np.float32)
    np.testing.assert_allclose(roi_align_rotated(feats, rois, 5, device="cuda").cpu().numpy(),
                               roi_align_rotated(feats, rois, 5, device="cpu").numpy(),
                               atol=1e-5)
    x = rng.standard_normal((1, 8, 20, 20)).astype(np.float32)
    w = (rng.standard_normal((4, 8, 3, 3)) / 8).astype(np.float32)
    off = rng.standard_normal((1, 18, 20, 20)).astype(np.float32)
    np.testing.assert_allclose(deform_conv2d(x, off, w, device="cuda").cpu().numpy(),
                               deform_conv2d(x, off, w, device="cpu").numpy(), atol=1e-5)


@pytest.mark.cuda
def test_cuda_time_context_tpu_waits(cuda_device):
    from marie_tpu_torch.logging_core.profile import TimeContextTPU

    x = torch.ones(4, device=cuda_device)
    torch.cuda.synchronize()
    with TimeContextTPU("wait", outputs_fn=lambda: [y]) as t:
        torch.cuda._sleep(50_000_000)
        y = x + 1
    assert torch.cuda.current_stream().query() and t.duration > 0.01


@pytest.mark.cuda
@pytest.mark.parametrize("rec_slots", [64, 3])
def test_cuda_single_page_dispatch_matches_cpu_and_launches(cuda_device, rec_slots):
    """``fused_dispatch`` + ``fused_collect_many`` of a grayscale page and
    an RGB page with distinct channels (tiny float32 models, ink boxes),
    card against CPU: equal boxes, lines and texts, confidences within
    1e-3; K1 (the grayscale page) and K2 launch on ``"single"``, and
    with 3 rows a page the rest go through the overflow path."""
    from marie_tpu_torch.boxes.craft_box_processor import BoxProcessorCraft
    from marie_tpu_torch.document.trocr_ocr_processor import TrOcrProcessor
    from marie_tpu_torch.enums import PSMode
    from marie_tpu_torch.models.configs import CraftConfig, TrOCRConfig
    from marie_tpu_torch.ocr.fused import fused_collect_many, fused_dispatch
    from marie_tpu_torch.ops.kernels import _build
    from marie_tpu_torch.preprocess.buckets import BucketSpec
    from marie_tpu_torch.registry.convert import init_flax_layout

    trees = (init_flax_layout(CraftConfig.tiny(), 5), init_flax_layout(TrOCRConfig.tiny(), 6))
    gray = _ink_page(22, 256, 384, n_words=12)
    rgb = np.stack([gray, np.clip(gray.astype(int) + 40, 0, 255).astype(np.uint8),
                    255 - (255 - gray) // 2], -1)
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        bp = BoxProcessorCraft(CraftConfig.tiny(), trees[0], box_source="ink",
                               max_components=64, min_area=4, device=dev,
                               bucket_spec=BucketSpec(shapes=((256, 384),)))
        op = TrOcrProcessor(TrOCRConfig.tiny(), trees[1], batch_sizes=(8, 32), device=dev)
        _build.reset_counts(k1.crop_resize, k2.flash_attention)
        handles = [fused_dispatch(bp, op, f, rec_slots=rec_slots) for f in (gray, rgb)]
        out.append(fused_collect_many(bp, op, handles, [PSMode.SPARSE] * 2))
        if dev.type == "cuda":
            assert k1.crop_resize.launches_by_path.get("single") == 1
            assert k2.flash_attention.launches_by_path.get("single", 0) > 0
            if rec_slots == 3:
                assert k2.flash_attention.launches_by_path.get("overflow", 0) > 0
    for got, want in zip(*out):
        for a, b in zip(got[:4], want[:4]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert [w["text"] for w in got[4]] == [w["text"] for w in want[4]]
        np.testing.assert_allclose([w["confidence"] for w in got[4]],
                                   [w["confidence"] for w in want[4]], rtol=0, atol=1e-3)
    assert sum(len(p[4]) for p in out[0]) > 6


_BWD_CASES = [  # (D, causal, Sq, Skv): 64-row blocks, 32-key tiles at D=64, 64 at D=32
    (64, False, 128, 128), (32, True, 70, 45),
    (64, False, 100, 77), (64, True, 200, 192), (32, False, 100, 77), (32, True, 130, 200),
]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["projections", "contiguous"])
@pytest.mark.parametrize("d,causal,sq,skv", _BWD_CASES)
def test_cuda_attention_backward_matches_plain(cuda_device, d, causal, sq, skv, layout):
    """K2's gradient kernel against autograd of the plain version (float32,
    TF32 off) within 1e-4 of each gradient's largest magnitude, on the
    projections' layout and on contiguous [B,H,S,D] tensors, with a fully
    masked row (kv_len 0), at lengths that are not multiples of the
    kernels' 64-row blocks and tiles; through the autograd path too, with
    one forward and one backward launch."""
    g = torch.Generator(device="cuda").manual_seed(3)
    b, h = 4, 4

    def make(s):
        if layout == "contiguous":
            return torch.randn(b, h, s, d, device="cuda", generator=g)
        return torch.randn(b, s, h, d, device="cuda", generator=g).transpose(1, 2)

    q, k, v, do = make(sq), make(skv), make(skv), make(sq)
    kv_len = torch.tensor([skv, 0, skv // 2, 1], dtype=torch.int32, device="cuda")
    want = k2.attention_backward_reference(q, k, v, do, causal=causal, kv_len=kv_len,
                                           sm_scale=d ** -0.5)
    _, lse = k2.flash_attention_lse(q, k, v, kv_len, causal)
    got = k2.flash_attention_backward(q, k, v, lse, do, kv_len, causal)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    fwd, bwd = k2.flash_attention.launches, k2.flash_attention_backward.launches
    k2.flash_attention(*leaves, kv_len=kv_len, causal=causal).backward(do)
    torch.cuda.synchronize()
    assert k2.flash_attention.launches == fwd + 1
    assert k2.flash_attention_backward.launches == bwd + 1
    for a, t, w in zip(got, leaves, want):
        scale = float(w.abs().max())
        assert float((a - w).abs().max()) <= 1e-4 * scale
        assert float((t.grad - w).abs().max()) <= 1e-4 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("d,causal,sq,skv", [(64, False, 128, 128), (32, True, 200, 160)])
def test_cuda_attention_backward_is_deterministic(cuda_device, d, causal, sq, skv):
    """Two calls on the same inputs give the same bits of dq, dk and dv:
    the kernels use no atomics, and their sums run in a fixed order."""
    g = torch.Generator(device="cuda").manual_seed(5)
    b, h = 8, 4
    q, k, v, do = (torch.randn(b, s, h, d, device="cuda", generator=g).transpose(1, 2)
                   for s in (sq, skv, skv, sq))
    kv_len = torch.randint(0, skv + 1, (b,), device="cuda", generator=g).to(torch.int32)
    _, lse = k2.flash_attention_lse(q, k, v, kv_len, causal)
    first = k2.flash_attention_backward(q, k, v, lse, do, kv_len, causal)
    second = k2.flash_attention_backward(q, k, v, lse, do, kv_len, causal)
    torch.cuda.synchronize()
    for a, b2 in zip(first, second):
        assert torch.equal(a, b2)


@pytest.mark.cuda
def test_cuda_attention_backward_near_equal_keys(cuda_device):
    """Keys a shared key + 1e-3 noise (the reading-order ranker's
    geometry), where dq = sum_j dS_ij k_j cancels: against float64
    autograd of the same attention, the kernel's dq is within twice the
    plain float32 gradient's own error (relative RMS), and dk and dv
    within 1e-5 of their largest magnitude."""
    g = torch.Generator(device="cuda").manual_seed(7)
    b, h, s, d = 4, 4, 256, 32
    base = torch.randn(b, 1, h, d, device="cuda", generator=g)
    q = torch.randn(b, s, h, d, device="cuda", generator=g).transpose(1, 2)
    k = (base + 1e-3 * torch.randn(b, s, h, d, device="cuda", generator=g)).transpose(1, 2)
    v, do = (torch.randn(b, s, h, d, device="cuda", generator=g).transpose(1, 2)
             for _ in range(2))
    kv_len = torch.tensor([256, 100, 37, 200], dtype=torch.int32, device="cuda")
    scale = d ** -0.5
    _, lse = k2.flash_attention_lse(q, k, v, kv_len)
    got = k2.flash_attention_backward(q, k, v, lse, do, kv_len)
    plain = k2.attention_backward_reference(q, k, v, do, kv_len=kv_len, sm_scale=scale)
    with torch.enable_grad():
        leaves = [t.detach().double().requires_grad_(True) for t in (q, k, v)]
        logits = torch.einsum("bhqd,bhkd->bhqk", leaves[0], leaves[1]) * scale
        seen = torch.arange(s, device="cuda")[None, None, None, :] < kv_len[:, None, None, None]
        probs = torch.softmax(torch.where(seen, logits, -1e30), dim=-1)
        out = torch.einsum("bhqk,bhkd->bhqd", probs, leaves[2])
        want = torch.autograd.grad(out, leaves, do.double())

    def rms(a, w):
        return float(((a.double() - w) ** 2).mean().sqrt() / (w ** 2).mean().sqrt())

    assert rms(got[0], want[0]) <= 2 * rms(plain[0], want[0])
    for a, w in zip(got[1:], want[1:]):
        assert float((a.double() - w).abs().max()) <= 1e-5 * float(w.abs().max())


@pytest.mark.cuda
def test_cuda_train_step_reaches_every_projection(cuda_device):
    """One AdamW step of the splitter's loss at a small width on the card:
    every attention projection's kernel gets a non-zero gradient (a K2
    without its backward would give q and k none), K2's forward and
    backward launch on ``"train"``, and the step matches the CPU's: loss
    within 1e-5, gradients within 1e-4 of each leaf's largest, parameters
    within 1e-5 where the gradient resolves.  Adam's first step moves a
    parameter by about the learning rate whatever its gradient's size, so
    where a component is below 1e-4 of its leaf's largest (the gradient
    check's resolution), and on the key biases (the loss does not depend
    on them), the two may step apart by up to twice the learning rate."""
    from marie_tpu_torch.models.configs import LayoutLMConfig
    from marie_tpu_torch.ops.kernels import _build
    from marie_tpu_torch.registry.convert import init_flax_defaults
    from marie_tpu_torch.train.layout import head_loss
    from marie_tpu_torch.train.loop import StepTrainer, init_module
    from marie_tpu_torch.train.optim import warmup_cosine_decay_schedule
    from marie_tpu_torch.utils.device import float32_precision

    cfg = LayoutLMConfig(vocab_size=512, hidden_dim=128, num_layers=2, num_heads=2,
                         mlp_dim=256, max_seq_len=64, use_image=False, num_labels=2)
    rng = np.random.default_rng(0)
    data = (rng.integers(2, 512, (8, 64)).astype(np.int32),
            np.sort(rng.integers(0, 1024, (8, 64, 4)), -1).astype(np.int32),
            rng.integers(1, 65, (8,)).astype(np.int32), rng.integers(0, 2, (8,)).astype(np.int32))
    tree = init_flax_defaults(cfg, 1, "sequence")
    lr = 1e-3
    runs = []
    for dev in (cuda_device, torch.device("cpu")):
        model = init_module(cfg, "sequence", 1, tree, dev)
        trainer = StepTrainer(model, head_loss(model, "sequence"),
                              warmup_cosine_decay_schedule(0.0, lr, 0, 10), 0.01)
        _build.reset_counts(k2.flash_attention, k2.flash_attention_backward)
        batch = [torch.from_numpy(a).to(dev) for a in data]
        with float32_precision(False), _build.launch_path("train"):
            loss = trainer.loss_fn(*batch)
            loss.backward()
        grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
        for name, g in grads.items():
            if name.endswith(("attn.q.weight", "attn.kv.k.weight", "attn.kv.v.weight")):
                assert float(g.abs().max()) > 0, name
        trainer.opt.step()
        runs.append((float(loss.detach()), grads,
                     {n: p.detach().cpu() for n, p in model.named_parameters()}))
        if dev.type == "cuda":
            assert k2.flash_attention.launches_by_path.get("train") == cfg.num_layers
            assert k2.flash_attention_backward.launches_by_path.get("train") == cfg.num_layers
    (l_card, g_card, p_card), (l_cpu, g_cpu, p_cpu) = runs
    assert abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu)
    for n, g in g_cpu.items():
        diff = (p_card[n] - p_cpu[n]).abs()
        if n.endswith("attn.kv.k.bias"):
            assert float(diff.max()) <= 2 * lr, n
            continue
        top = float(g.abs().max())
        assert float((g_card[n] - g).abs().max()) <= 1e-4 * top, n
        resolved = g.abs() >= 1e-4 * top
        assert float(diff[resolved].max()) <= 1e-5, n
        if bool((~resolved).any()):
            assert float(diff[~resolved].max()) <= 2 * lr, n


@pytest.mark.cuda
def test_cuda_attention_gradient_refuses_what_it_does_not_take(cuda_device):
    """With a gradient wanted, D=128 and bf16 raise on the card (no path
    gives way to the plain version); without one they run."""
    q = torch.randn(2, 2, 16, 128, device="cuda", requires_grad=True)
    with pytest.raises(ValueError, match="training path"):
        k2.flash_attention(q, q, q)
    qb = torch.randn(2, 2, 16, 64, device="cuda", dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(ValueError, match="training path"):
        k2.flash_attention(qb, qb, qb)
    with torch.no_grad():
        assert k2.flash_attention(q, q, q).shape == q.shape
