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
