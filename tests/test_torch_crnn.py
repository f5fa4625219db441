"""The port's CRNN/CTC recogniser and the ``best`` engine against the JAX
package on the CPU: the CRNN's logits (both backbones at tiny width, and
the trained ``crnn-synth`` tree), greedy CTC, the CTC tokenizer, cv2's
uint8 ``COLOR_RGB2GRAY`` in numpy, the grayscale crops, the CRNN
processor's device and fragment paths on two shipped pages, the voting
engine with fixed recognisers, the ``best`` engine with tiny seeded
models in SPARSE and WORD mode, and the registry's ``best`` engine on
two shipped pages against its golden.

Limits: logits within 1e-4 (float32 convolutions and LSTMs in another
summation order), CTC confidences within 1e-6, processor confidences
within 1e-5, engine result dicts equal with confidences within 1e-3
(rounded to 3 decimals); crops, grayscale and tokens exactly.
"""

import dataclasses
import json
import os

import cv2
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from marie_tpu.boxes.craft_box_processor import BoxProcessorCraft as JaxBoxProcessorCraft
from marie_tpu.document.crnn_ocr_processor import CrnnOcrProcessor as JaxCrnnOcrProcessor
from marie_tpu.document.ocr_processor import OcrProcessor as JaxOcrProcessor
from marie_tpu.document.trocr_ocr_processor import TrOcrProcessor as JaxTrOcrProcessor
from marie_tpu.enums import CoordinateFormat as JaxCoordinateFormat
from marie_tpu.enums import PSMode as JaxPSMode
from marie_tpu.models import configs as jcfg
from marie_tpu.models.crnn import CRNN as JaxCRNN
from marie_tpu.models.tokenizer import CTCCharTokenizer as JaxCTCCharTokenizer
from marie_tpu.ocr.voting_ocr_engine import VotingOcrEngine as JaxVotingOcrEngine
from marie_tpu.ops.ctc import ctc_greedy_decode as jax_ctc_greedy_decode
from marie_tpu.preprocess import BucketSpec as JaxBucketSpec
from marie_tpu.registry.checkpoints import load_params as load_orbax
from marie_tpu_torch.boxes.craft_box_processor import BoxProcessorCraft
from marie_tpu_torch.check import agreement, compare_results, truth_pages
from marie_tpu_torch.document.crnn_ocr_processor import CrnnOcrProcessor, gray_crops
from marie_tpu_torch.document.ocr_processor import OcrProcessor
from marie_tpu_torch.document.trocr_ocr_processor import TrOcrProcessor
from marie_tpu_torch.enums import CoordinateFormat, PSMode
from marie_tpu_torch.models import configs as tcfg
from marie_tpu_torch.models.tokenizer import CTCCharTokenizer
from marie_tpu_torch.ocr.voting_ocr_engine import VotingOcrEngine
from marie_tpu_torch.ops.ctc import ctc_greedy_decode
from marie_tpu_torch.ops.kernels.crop_resize import crop_resize
from marie_tpu_torch.ops.kernels.flash_attention import flash_attention
from marie_tpu_torch.preprocess.buckets import BucketSpec
from marie_tpu_torch.preprocess.resize import rgb2gray_u8
from marie_tpu_torch.registry.convert import (
    _flatten,
    build_model,
    from_flax,
    init_flax_layout,
    load_model,
)
from marie_tpu_torch.registry.zoo import ZOO_DIR, open_zoo_json, zoo_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 96, 128
BUCKETS = ((H, W),)


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _crnn_config(width: str, backbone: str):
    cfg = tcfg.CRNNConfig.tiny() if width == "tiny" else tcfg.CRNNConfig()
    cfg = dataclasses.replace(cfg, backbone=backbone)
    return cfg, jcfg.CRNNConfig(**dataclasses.asdict(cfg))


def _page(seed: int, h: int = H, w: int = W, n_words: int = 4) -> np.ndarray:
    """A white [h, w] page with word-shaped ink blocks at seeded places."""
    rng = np.random.default_rng(seed)
    page = np.full((h, w), 255, np.uint8)
    for _ in range(n_words):
        ww, th = int(rng.integers(16, 40)), int(rng.integers(8, 14))
        x, y = int(rng.integers(4, w - ww - 4)), int(rng.integers(4, h - th - 4))
        level = int(rng.integers(0, 90))
        for gx in range(x, x + ww, int(rng.integers(4, 6))):
            page[y + int(rng.integers(0, 2)):y + th, gx:gx + 2] = level
        page[y + th // 2:y + th // 2 + 2, x:x + ww] = level
    return page


@pytest.fixture(scope="module")
def shipped():
    with np.load(os.path.join(ZOO_DIR, "pages.npz")) as data:
        pages = data["pages"]
    with open_zoo_json("truth") as f:
        truth = json.load(f)
    with open_zoo_json("golden_best") as f:
        golden = json.load(f)
    return pages, truth, golden


@pytest.fixture(scope="module")
def crnn_synth():
    """(port processor, JAX processor) on the committed crnn-synth tree."""
    tree = zoo_params("crnn-synth")
    assert tree is not None, "torch_zoo/crnn-synth.npz is missing"
    return (CrnnOcrProcessor(variables=tree, device="cpu"),
            JaxCrnnOcrProcessor(variables=_jax_tree(tree)))


@pytest.mark.parametrize("width,backbone", [("tiny", "vgg"), ("tiny", "resnet")])
def test_crnn_logits_match_flax(width, backbone):
    """Seeded weights through the bridge; the columns past the ink are
    white, which the backward LSTM reads (nothing is packed)."""
    cfg_t, cfg_j = _crnn_config(width, backbone)
    tree = init_flax_layout(cfg_t, 3)
    x = np.random.default_rng(1).random((3, 32, 128, 1)).astype(np.float32)
    x[:, :, 80:] = 1.0
    want = np.asarray(JaxCRNN(cfg_j).apply(_jax_tree(tree), jnp.asarray(x)))
    with torch.no_grad():
        got = load_model(cfg_t, tree, device="cpu")(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, 32, cfg_t.num_classes)
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("bucket_w", [64, 256])
def test_crnn_synth_logits_match_flax(crnn_synth, bucket_w):
    port, jproc = crnn_synth
    x = np.random.default_rng(bucket_w).random((4, 32, bucket_w, 1)).astype(np.float32)
    want = np.asarray(jproc._fwd(jproc.variables, jnp.asarray(x)))
    with torch.no_grad():
        got = port.model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (4, bucket_w // 4, 96)
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("width,backbone", [("tiny", "vgg"), ("default", "resnet")])
def test_crnn_init_flax_layout_has_the_flax_tree(width, backbone):
    """Same paths and shapes as ``model.init`` of the flax CRNN (the LSTM
    cells under their flax names)."""
    cfg_t, cfg_j = _crnn_config(width, backbone)
    want = {p: tuple(x.shape) for p, x in _flatten(jax.eval_shape(
        JaxCRNN(cfg_j).init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 64, 1))))}
    got = {p: np.shape(x) for p, x in _flatten(init_flax_layout(cfg_t, 0))}
    assert got == want


def test_crnn_from_flax_is_strict():
    cfg = tcfg.CRNNConfig.tiny()
    tree = init_flax_layout(cfg, 0)
    del tree["params"]["OptimizedLSTMCell_3"]["hf"]["bias"]
    with pytest.raises(RuntimeError, match="OptimizedLSTMCell_3"):
        from_flax(tree, build_model(cfg))
    tree = init_flax_layout(cfg, 0)
    tree["params"]["OptimizedLSTMCell_4"] = tree["params"]["OptimizedLSTMCell_0"]
    with pytest.raises(RuntimeError, match="OptimizedLSTMCell_4"):
        from_flax(tree, build_model(cfg))


def test_committed_crnn_tree_equals_orbax():
    """torch_zoo/crnn-synth.npz is the orbax checkpoint, float32, to the bit."""
    want = dict(_flatten(jax.device_get(load_orbax(os.path.join(REPO, "model_zoo",
                                                                  "crnn-synth")))))
    got = dict(_flatten(zoo_params("crnn-synth")))
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], np.asarray(w))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ctc_greedy_decode_matches_jax(seed):
    """Frames drawn from few ids, so repeats and blanks are common."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((5, 24, 7)).astype(np.float32)
    ids = rng.integers(0, 3, (5, 24))
    np.put_along_axis(logits, ids[..., None], 4.0, axis=-1)
    logits[1] = 0.0  # every frame ties: argmax is the first id, the blank
    want = jax_ctc_greedy_decode(jnp.asarray(logits), blank_id=0)
    got = ctc_greedy_decode(torch.from_numpy(logits), blank_id=0)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=0, atol=1e-6)
    assert got[0].dtype == got[1].dtype == torch.int32


def test_ctc_greedy_decode_collapses():
    """The JAX package's own case: [1 1 0 2 2 2 0 1] -> [1, 2, 1]."""
    ids = [1, 1, 0, 2, 2, 2, 0, 1]
    logits = torch.full((1, 8, 4), -10.0)
    for i, k in enumerate(ids):
        logits[0, i, k] = 10.0
    tokens, lengths, conf = ctc_greedy_decode(logits)
    assert int(lengths[0]) == 3
    assert tokens[0].tolist() == [1, 2, 1, -1, -1, -1, -1, -1]
    assert float(conf[0]) > 0.99


def test_ctc_tokenizer_matches_jax():
    got, want = CTCCharTokenizer(), JaxCTCCharTokenizer()
    assert (got.vocab_size, got.blank_id) == (want.vocab_size, want.blank_id)
    assert got.encode("Total: $45.00\t") == want.encode("Total: $45.00\t")
    ids = np.asarray([[0, 5, 5, 96, 200, 3, -1], [1, 2, 3, 0, 0, -1, -1]])
    assert got.decode_batch(ids) == [want.decode(r) for r in ids]
    assert got.decode(ids[0]) == want.decode(ids[0])


@settings(max_examples=40, deadline=None)
@given(h=st.integers(1, 40), w=st.integers(1, 300), chans=st.sampled_from([3, 4]),
       seed=st.integers(0, 2**31 - 1))
def test_rgb2gray_matches_cv2(h, w, chans, seed):
    img = np.random.default_rng(seed).integers(0, 256, (h, w, chans), dtype=np.uint8)
    np.testing.assert_array_equal(rgb2gray_u8(img), cv2.cvtColor(img, cv2.COLOR_RGB2GRAY))


def test_rgb2gray_refuses_other_inputs():
    with pytest.raises(ValueError):
        rgb2gray_u8(np.zeros((4, 4), np.uint8))
    with pytest.raises(ValueError):
        rgb2gray_u8(np.zeros((4, 4, 3), np.float32))


class _CaptureCrops:
    """Stand-in CRNN for the JAX processor's ``_crop_and_ctc`` program:
    hands the crops it is given to the host, returns blank logits."""

    def __init__(self):
        self.seen = []

    def apply(self, variables, gray):
        jax.debug.callback(lambda g: self.seen.append(np.asarray(g)), gray)
        return jnp.zeros((gray.shape[0], gray.shape[2] // 4, 4))


@pytest.mark.parametrize("form", ["gray", "rgb"])
def test_gray_crops_equal_jax_to_the_bit(form):
    """The crops the JAX processor's program feeds its CRNN: it crops a
    [H, W, 3] page (three equal channels for a grayscale one) and takes
    the channel mean, fused with the crop's scale.  The port crops a
    grayscale [H, W] page with K1's channel mean (here its plain
    version), an RGB one with stock ops.  Equal to the bit; for the
    grayscale page the mean is not the one channel's crop."""
    from marie_tpu.document.crnn_ocr_processor import _crop_and_ctc as jax_crop_and_ctc

    rng = np.random.default_rng(4)
    page = rng.integers(0, 256, (H, W), dtype=np.uint8)
    rgb = (np.repeat(page[..., None], 3, -1) if form == "gray"
           else rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
    x0, y0 = rng.uniform(-5, W - 20, 16), rng.uniform(-5, H - 10, 16)
    boxes = np.stack([x0, y0, x0 + rng.uniform(2, 200, 16), y0 + rng.uniform(2, 40, 16)],
                     -1).astype(np.float32)
    capture = _CaptureCrops()
    jax.block_until_ready(jax_crop_and_ctc(capture, {}, jnp.asarray(rgb), jnp.asarray(boxes),
                                           32, 256))
    want = capture.seen[-1]
    dev_page = torch.from_numpy(page if form == "gray" else rgb)
    got = gray_crops(dev_page, torch.from_numpy(boxes), 32, 256).numpy()
    assert got.shape == want.shape == (16, 32, 256, 1)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    if form == "gray":
        plain = crop_resize(dev_page[None], torch.zeros(16, dtype=torch.int32),
                            torch.from_numpy(boxes), 32, 256)[0].numpy()[..., None]
        assert (plain != want).mean() > 0.05


def test_crnn_processor_device_and_fragments_match_jax(shipped, crnn_synth):
    """On two shipped pages (their truth boxes, 280 words): the device path
    (the page on the device, crops cut there) and host fragments (gray
    and RGB cut-outs) read the same texts as the JAX processor, with
    confidences within 1e-5."""
    pages, truth, _ = shipped
    port, jproc = crnn_synth
    for i in (0, 1):
        boxes = np.asarray([b for _, b in truth["pages"][i]], np.float32)
        page = pages[i]
        want = jproc.recognize_collect(jproc.recognize_dispatch(
            jnp.asarray(np.repeat(page[..., None], 3, -1)), boxes))
        got = port.recognize_collect_many([port.recognize_dispatch(
            torch.from_numpy(page), boxes)])[0]
        assert [w["text"] for w in got] == [w["text"] for w in want]
        np.testing.assert_allclose([w["confidence"] for w in got],
                                   [w["confidence"] for w in want], rtol=0, atol=1e-5)
        assert sum(w["text"] == t for w, (t, _) in zip(got, truth["pages"][i])) > 0.9 * len(got)
    frags = []
    for x, y, w, h in ([int(v) for v in b] for _, b in truth["pages"][0][:40]):
        frag = pages[0][y:y + h, x:x + w]
        frags += [frag, np.stack([frag, frag // 2, 255 - frag // 3], -1)]
    want = jproc.recognize_from_fragments(frags)
    got = port.recognize_from_fragments(frags)
    assert [w["text"] for w in got] == [w["text"] for w in want]
    np.testing.assert_allclose([w["confidence"] for w in got],
                               [w["confidence"] for w in want], rtol=0, atol=1e-5)


def _ink_processors():
    craft = init_flax_layout(tcfg.CraftConfig.tiny(), 7)
    jbp = JaxBoxProcessorCraft(config=jcfg.CraftConfig.tiny(), box_source="ink",
                               max_components=32, variables=_jax_tree(craft),
                               bucket_spec=JaxBucketSpec(shapes=BUCKETS))
    tbp = BoxProcessorCraft(tcfg.CraftConfig.tiny(), craft, box_source="ink", max_components=32,
                            bucket_spec=BucketSpec(shapes=BUCKETS), device="cpu")
    return jbp, tbp


def test_voting_engine_with_fixed_processors():
    """The JAX package's case: the majority wins over a higher confidence,
    and the confidence is the winners' mean; an unavailable recogniser
    does not vote, and none available raises."""
    def fixed(base, text, conf, available=True):
        class Fixed(base):
            def __init__(self):
                if base is JaxOcrProcessor:
                    super().__init__()

            def is_available(self):
                return available

            def recognize_from_fragments(self, fragments):
                return [{"text": text, "confidence": conf} for _ in fragments]
        return Fixed()

    jbp, tbp = _ink_processors()
    page = _page(3)
    for spec in ([("yes", 0.8), ("yes", 0.7), ("no", 0.99)],
                 [("yes", 0.8), ("no", 0.9), ("no", 0.99, False)]):
        want = JaxVotingOcrEngine(jbp, [fixed(JaxOcrProcessor, *s) for s in spec]).extract(
            [page], coordinate_format=JaxCoordinateFormat.XYXY)
        got = VotingOcrEngine(tbp, [fixed(OcrProcessor, *s) for s in spec]).extract(
            [page], coordinate_format=CoordinateFormat.XYXY)
        assert got == want and len(got[0]["words"]) > 1
    assert got[0]["words"][0]["text"] == "no"  # 1-vs-1: the higher confidence
    assert want[0]["words"][0]["confidence"] == 0.9
    assert VotingOcrEngine._vote([]) == {"text": "", "confidence": 0.0}
    with pytest.raises(RuntimeError, match="no ocr_processor is available"):
        VotingOcrEngine(tbp, [fixed(OcrProcessor, "x", 1.0, False)]).extract([page])
    with pytest.raises(ValueError):
        VotingOcrEngine(tbp, [])


@pytest.fixture(scope="module")
def tiny_best():
    """(JAX, port) ``best`` engines over the same tiny seeded models: ink
    CRAFT, TrOCR beam-5 and a CRNN, float32."""
    jbp, tbp = _ink_processors()
    trocr = init_flax_layout(tcfg.TrOCRConfig.tiny(), 8)
    crnn = init_flax_layout(tcfg.CRNNConfig.tiny(), 9)
    jax_engine = JaxVotingOcrEngine(jbp, [
        JaxTrOcrProcessor(config=jcfg.TrOCRConfig.tiny(), params=_jax_tree(trocr),
                          beam_size=5, batch_sizes=(4, 8)),
        JaxCrnnOcrProcessor(config=jcfg.CRNNConfig.tiny(), variables=_jax_tree(crnn),
                            batch_sizes=(4, 8))])
    port_engine = VotingOcrEngine(tbp, [
        TrOcrProcessor(tcfg.TrOCRConfig.tiny(), trocr, beam_size=5, batch_sizes=(4, 8),
                       device="cpu"),
        CrnnOcrProcessor(tcfg.CRNNConfig.tiny(), crnn, batch_sizes=(4, 8), device="cpu")])
    return jax_engine, port_engine


def _assert_same_results(got, want):
    def strip(results):
        return [dict(r, words=[dict(w, confidence=None) for w in r["words"]],
                     lines=[dict(ln, confidence=None) for ln in r["lines"]]) for r in results]

    assert strip(got) == strip(want)
    confs = [[x["confidence"] for r in rs for x in r["words"] + r["lines"]]
             for rs in (got, want)]
    np.testing.assert_allclose(*confs, rtol=0, atol=1e-3)


@pytest.mark.parametrize("mode,fmt", [("sparse", "xywh"), ("line", "xyxy"), ("word", "xywh"),
                                      ("raw_line", "xywh"), ("multiline", "xyxy")])
def test_tiny_best_engine_matches_jax(tiny_best, mode, fmt):
    """SPARSE and LINE take the device path (one detection feeds both
    recognisers), the other modes host fragments; three pages, one of
    them RGB.  Nothing launches a kernel on the CPU."""
    jax_engine, port_engine = tiny_best
    pages = [_page(11, n_words=6), _page(12), np.repeat(_page(13)[..., None], 3, -1)]
    if mode in ("word", "raw_line"):
        pages = [p[10:40, 5:90] for p in pages]
    want = jax_engine.extract(pages, JaxPSMode.from_value(mode), JaxCoordinateFormat(fmt))
    for fn in (crop_resize, flash_attention):
        fn.launches = 0
    got = port_engine.extract(pages, PSMode.from_value(mode), CoordinateFormat(fmt))
    _assert_same_results(got, want)
    assert sum(len(r["words"]) for r in got) >= len(pages)
    assert crop_resize.launches == flash_attention.launches == 0


def test_best_registry_engine_on_shipped_pages(shipped):
    """``get_known_ocr_engines("cpu", "best")`` loads CRAFT, TrOCR (beam 5)
    and the CRNN from the zoo and, on two shipped pages and the WORD
    snippet, stays within the golden's limits (matched words with equal
    text >= 0.99, recall within 0.005, CER at most 0.005 over the
    golden's): bf16 convolutions move a few boxes by a pixel."""
    from marie_tpu_torch.ocr.util import get_known_ocr_engines

    pages, truth, golden = shipped
    engine = get_known_ocr_engines("cpu", "best")["best"]
    assert engine.trained == {"detector": "craft-s2d2-synth",
                              "recognizers": ["trocr-fast3g2d6ov-synth", "crnn-synth"]}
    assert [p.beam_size for p in engine.ocr_processors[:1]] == [5]
    got = engine.extract(list(pages[:2]))
    want = golden["pages"][:2]
    assert agreement(want, got)["words"] >= 0.99
    gold = truth_pages(truth["pages"][:2], [(1024, 768)] * 2)
    mine, theirs = (compare_results(gold, r, iou_threshold=0.4) for r in (got, want))
    assert abs(mine["detection"]["recall"] - theirs["detection"]["recall"]) <= 0.005
    assert mine["recognition"]["cer"] <= theirs["recognition"]["cer"] + 0.005
    spec = golden["word"]
    x, y, w, h = spec["box"]
    word = engine.extract([pages[spec["page"]][y:y + h, x:x + w]], PSMode.WORD)[0]
    _assert_same_results([word], [spec["result"]])


def test_golden_best_is_shipped(shipped):
    pages, _, golden = shipped
    assert len(golden["pages"]) == len(pages) == 16
    assert sum(len(p["words"]) for p in golden["pages"]) > 2000
    assert golden["word"]["result"]["words"]
