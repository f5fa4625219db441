"""The port's small host modules against the JAX package's on the same
inputs (ROADMAP §1 item 13, first part): the Tesseract and cloud OCR
shells, ``ModelRegistry``, ``utils/visualize.py``, ``utils/codec.py``,
``utils/backoff.py`` and ``utils/merger.py``.  These JAX modules import no
JAX, so both sides run here.

Limits: equal results everywhere but where the port departs on purpose
(ROADMAP §3): the visualisation's labels (an atlas face where PIL draws
its default font: the pixels outside the label boxes equal PIL's), and the
PNG bytes the codec and the crops write (``image_io``'s filter 0 where PIL
chooses adaptive filters: the decoded pixels equal).
"""

import asyncio
import base64
import io
import os

import numpy as np
import pytest
from PIL import Image

from marie_tpu.document import cloud_ocr_processors as jcloud
from marie_tpu.document import tesseract_ocr_processor as jtess
from marie_tpu.excepts import ModelRegistryError as JaxRegistryError
from marie_tpu.registry import model_registry as jreg
from marie_tpu.utils import backoff as jbackoff
from marie_tpu.utils import codec as jcodec
from marie_tpu.utils import merger as jmerger
from marie_tpu.utils import visualize as jvis
from marie_tpu_torch.document import cloud_ocr_processors as tcloud
from marie_tpu_torch.document import tesseract_ocr_processor as ttess
from marie_tpu_torch.excepts import ModelRegistryError
from marie_tpu_torch.registry import model_registry as treg
from marie_tpu_torch.utils import backoff as tbackoff
from marie_tpu_torch.utils import codec as tcodec
from marie_tpu_torch.utils import merger as tmerger
from marie_tpu_torch.utils import visualize as tvis


# ---------------------------------------------------------- the OCR shells
@pytest.mark.parametrize("name", ["GoogleVisionOcrProcessor", "AzureVisionOcrProcessor",
                                  "AwsTextractOcrProcessor"])
def test_cloud_shells_are_unavailable_and_raise_as_jax(name):
    jax_proc, port = getattr(jcloud, name)(work_dir="/tmp/x"), getattr(tcloud, name)("/tmp/x")
    assert port.is_available() is jax_proc.is_available() is False
    assert port.work_dir == jax_proc.work_dir
    frags = [np.zeros((8, 8), np.uint8)]
    with pytest.raises(NotImplementedError) as want:
        jax_proc.recognize_from_fragments(frags)
    with pytest.raises(NotImplementedError) as got:
        port.recognize_from_fragments(frags)
    assert str(got.value) == str(want.value)


def test_tesseract_shell_without_its_engine():
    """Neither pytesseract nor the tesseract binary is here: both shells
    report unavailable and raise on use; the port never imports PIL."""
    import shutil

    assert shutil.which("tesseract") is None
    jax_proc, port = jtess.TesseractOcrProcessor(lang="deu"), ttess.TesseractOcrProcessor(
        lang="deu")
    assert port.is_available() is jax_proc.is_available() is False
    assert port.lang == jax_proc.lang == "deu"
    for proc in (jax_proc, port):
        with pytest.raises(RuntimeError, match="unavailable"):
            proc.recognize_from_fragments([np.zeros((8, 8), np.uint8)])


def test_voting_engine_skips_the_shells():
    """A voting engine over the shells and a working recogniser recognises
    with the working one; over the shells alone it refuses."""
    from marie_tpu_torch.document import (
        AwsTextractOcrProcessor,
        GoogleVisionOcrProcessor,
        TesseractOcrProcessor,
    )
    from marie_tpu_torch.document.ocr_processor import OcrProcessor
    from marie_tpu_torch.enums import CoordinateFormat, PSMode
    from marie_tpu_torch.ocr.voting_ocr_engine import VotingOcrEngine

    class Words(OcrProcessor):
        def recognize_from_fragments(self, fragments):
            return [{"text": "word", "confidence": 0.99} for _ in fragments]

    class Boxes:
        def extract_bounding_boxes(self, queue_id, checksum, image, psm=None):
            return [[2, 2, 10, 6]], [image[2:8, 2:12]], [0], None, [[2, 2, 10, 6]]

    shells = [TesseractOcrProcessor(), GoogleVisionOcrProcessor(), AwsTextractOcrProcessor()]
    page = np.full((20, 30), 255, np.uint8)
    engine = VotingOcrEngine(Boxes(), shells + [Words()])
    (result,) = engine.extract([page], PSMode.WORD, CoordinateFormat.XYWH)
    assert [w["text"] for w in result["words"]] == ["word"]
    with pytest.raises(RuntimeError, match="no ocr_processor is available"):
        VotingOcrEngine(Boxes(), shells).extract([page], PSMode.WORD, CoordinateFormat.XYWH)


# ------------------------------------------------------------ the registry
def _zoo(tmp_path):
    for d, names in (("a", ("m1", "shared")), ("b", ("m2", "shared"))):
        for n in names:
            (tmp_path / d / n).mkdir(parents=True)
    return [str(tmp_path / "a"), str(tmp_path / "b")]


@pytest.mark.parametrize("name", ["zoo://m1", "zoo://m2", "zoo://shared", "m1", "zoo://none"])
def test_zoo_handler_matches_jax(tmp_path, name):
    dirs = _zoo(tmp_path)
    jax_h, port = jreg.NativeModelRegistryHandler(dirs), treg.NativeModelRegistryHandler(dirs)
    assert port.get_supported_prefixes() == jax_h.get_supported_prefixes()
    assert port.exists(name) == jax_h.exists(name)
    if jax_h.exists(name):
        assert port.resolve(name) == jax_h.resolve(name)
    else:
        with pytest.raises(JaxRegistryError):
            jax_h.resolve(name)
        with pytest.raises(ModelRegistryError):
            port.resolve(name)


def test_zoo_handler_finds_npz_trees(tmp_path):
    """The port's zoo holds ``<name>.npz`` trees: a name resolves to its
    file, a directory of that name first."""
    (tmp_path / "tree.npz").write_bytes(b"")
    port = treg.NativeModelRegistryHandler([str(tmp_path)])
    assert port.resolve("zoo://tree") == str(tmp_path / "tree.npz")
    (tmp_path / "tree").mkdir()
    assert port.resolve("zoo://tree") == str(tmp_path / "tree")
    assert treg.NativeModelRegistryHandler().zoo_dirs[0] == treg.ZOO_DIR


def test_hf_handler_reads_the_cache_only(tmp_path, monkeypatch):
    monkeypatch.setenv("HF_HOME", str(tmp_path))
    jax_h, port = jreg.HuggingFaceModelRegistryHandler(), treg.HuggingFaceModelRegistryHandler()
    name = "hf://org/model"
    assert port.exists(name) is jax_h.exists(name) is False
    with pytest.raises(ModelRegistryError, match="downloads"):
        port.resolve(name)
    for snap in ("abc", "def"):
        (tmp_path / "hub" / "models--org--model" / "snapshots" / snap).mkdir(parents=True)
    assert port.resolve(name) == jax_h.resolve(name) == str(
        tmp_path / "hub" / "models--org--model" / "snapshots" / "def")


def test_model_registry_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    dirs = _zoo(tmp_path)
    for mod in (jreg, treg):
        monkeypatch.setattr(mod.ModelRegistry, "_handlers", {})
        mod.ModelRegistry.register_handler(mod.NativeModelRegistryHandler(dirs))
    for name in ("zoo://m2", str(tmp_path / "a" / "m1"), "hf://org/none", "nowhere"):
        assert treg.ModelRegistry.exists(name) == jreg.ModelRegistry.exists(name)
        if jreg.ModelRegistry.exists(name):
            assert treg.ModelRegistry.get(name) == jreg.ModelRegistry.get(name)
        else:
            with pytest.raises(ModelRegistryError):
                treg.ModelRegistry.get(name)
    assert sorted(treg.ModelRegistry._handlers) == sorted(jreg.ModelRegistry._handlers)


# ------------------------------------------------------- the visualisation
_RESULT = {"words": [
    {"box": [10, 20, 50, 15], "text": "invoice", "confidence": 0.97},
    {"box": [70, 40, 40, 30], "text": "héllo/2", "confidence": 0.85},
    {"box": [150, 100, 60, 30], "text": "", "confidence": 0.2},
    {"box": [190, 110, 40, 20], "text": "edge", "confidence": 0.5},
    {"box": [5, 2, 0, 0], "text": "dot", "confidence": 0.99},
]}


@pytest.mark.parametrize("channels", [None, 3, 4])
def test_draw_ocr_overlay_boxes_equal_jax(channels, tmp_path):
    rng = np.random.default_rng(channels or 1)
    shape = (120, 210) if channels is None else (120, 210, channels)
    page = rng.integers(100, 256, shape).astype(np.uint8)
    want = jvis.draw_ocr_overlay(page, _RESULT, show_text=False)
    got = tvis.draw_ocr_overlay(page, _RESULT, path=str(tmp_path / "o.png"), show_text=False)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "o.png")), want)


def test_draw_ocr_overlay_labels_only_in_their_boxes(tmp_path):
    """With labels: equal to JAX's outside each label's box (the port's
    face differs from PIL's default font), ink inside each one, and a
    ``.tif`` written as PIL reads it."""
    from marie_tpu_torch.utils.glyphs import load_font

    page = np.full((120, 210), 230, np.uint8)
    want = jvis.draw_ocr_overlay(page, _RESULT)
    got = tvis.draw_ocr_overlay(page, _RESULT, path=str(tmp_path / "o.tif"))
    plain = tvis.draw_ocr_overlay(page, _RESULT, show_text=False)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "o.tif")), got)
    font = load_font(tvis.LABEL_FACE, tvis.LABEL_SIZE)
    inside = np.zeros(page.shape, bool)
    for w in _RESULT["words"]:
        if not w["text"]:
            continue
        x, y = w["box"][0], max(w["box"][1] - 12, 0)
        label = f"{w['text']} {w['confidence']:.2f}".replace("é", "?")
        l, t, r, b = font.textbbox((x, y), label)
        assert (got[t:b, l:r] != plain[t:b, l:r]).any(), label
        # PIL's default font's box too: both labels may cover it
        inside[max(t - 4, 0):b + 4, max(l, 0):r + 60] = True
    np.testing.assert_array_equal(got[~inside], want[~inside])
    with pytest.raises(ValueError, match=".png and .tif"):
        tvis.draw_ocr_overlay(page, _RESULT, path=str(tmp_path / "o.gif"))


def test_dump_low_confidence_crops_match_jax(tmp_path):
    page = np.random.default_rng(3).integers(0, 256, (120, 210, 3)).astype(np.uint8)
    want = jvis.dump_low_confidence_crops(page, _RESULT, str(tmp_path / "j"), threshold=0.9)
    got = tvis.dump_low_confidence_crops(page, _RESULT, str(tmp_path / "t"), threshold=0.9)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    assert len(got) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(Image.open(g)), np.asarray(Image.open(w)))
    for text in ("a b/c", "", "!!", "naïve"):
        assert tvis.normalize_label(text) == jvis.normalize_label(text)
    for conf in (0.99, 0.95, 0.9, 0.8, 0.5, -1.0):
        assert tvis._color_for(conf) == jvis._color_for(conf)


# ---------------------------------------------------------------- the codec
@pytest.mark.parametrize("shape", [(17, 23), (9, 31, 3)])
def test_codec_round_trips_with_jax(shape):
    img = np.random.default_rng(len(shape)).integers(0, 256, shape).astype(np.uint8)
    port_text, jax_text = tcodec.encode_to_base64(img), jcodec.encode_to_base64(img)
    for text in (port_text, jax_text):
        np.testing.assert_array_equal(tcodec.base64_to_image(text), img)
        np.testing.assert_array_equal(jcodec.base64_to_image(text), img)
    assert tcodec.encodeToBase64 is tcodec.encode_to_base64
    for data in (None, base64.b64encode(b"\x00\xffbytes").decode()):
        assert tcodec.base64_to_bytes(data) == jcodec.base64_to_bytes(data)
        assert tcodec.base64StringToBytes(data) == jcodec.base64StringToBytes(data)
    with pytest.raises(ValueError, match="PNG only"):
        tcodec.encode_to_base64(img, format="JPEG")


def test_codec_reads_jpeg_and_tiff_as_pil():
    img = np.random.default_rng(7).integers(0, 256, (16, 24, 3)).astype(np.uint8)
    for fmt in ("JPEG", "TIFF"):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format=fmt)
        text = base64.b64encode(buf.getvalue()).decode()
        np.testing.assert_array_equal(tcodec.base64_to_image(text), jcodec.base64_to_image(text))


# --------------------------------------------------- backoff and the merger
def _flaky(fails, exc=ConnectionError):
    calls = []

    def fn(a, b=0):
        calls.append((a, b))
        if len(calls) <= fails:
            raise exc("down")
        return a + b

    return fn, calls


@pytest.mark.parametrize("fails,max_retries", [(0, 4), (3, 4), (4, 4), (5, 4), (2, 1)])
def test_backoff_matches_jax(fails, max_retries):
    outcomes = []
    for mod in (jbackoff, tbackoff):
        fn, calls = _flaky(fails)
        slept = []
        try:
            out = mod.backoff(fn, (ConnectionError,), args=(2,), kwargs={"b": 3},
                              max_retries=max_retries, sleep=slept.append)
        except ConnectionError as e:
            out = repr(e)
        outcomes.append((out, calls, slept))
    assert outcomes[0] == outcomes[1]
    for mod in (jbackoff, tbackoff):
        fn, _ = _flaky(1, exc=KeyError)
        with pytest.raises(KeyError):
            mod.backoff(fn, (ConnectionError,), args=(1,), sleep=lambda s: None)
        with pytest.raises(TypeError):
            mod.backoff(3, (ConnectionError,))
    gen = tbackoff.backoff_delay_generator(0.25)
    assert [next(gen) for _ in range(4)] == [0.25, 0.5, 1.0, 2.0]


def test_abackoff_matches_jax():
    async def run(mod, fails):
        calls = []

        async def fn(a):
            calls.append(a)
            if len(calls) <= fails:
                raise TimeoutError("slow")
            return a * 2

        delays = mod.backoff_delay_generator(0.0)
        try:
            return await mod.abackoff(fn, (TimeoutError,), args=(4,), max_retries=2,
                                      delay_generator=delays), calls
        except TimeoutError:
            return "raised", calls

    for fails in (0, 2, 3):
        assert asyncio.run(run(tbackoff, fails)) == asyncio.run(run(jbackoff, fails))


@pytest.mark.parametrize("onto,from_dict", [
    ({"a": 1, "b": {"c": 2, "d": {"e": 3}}}, {"b": {"d": {"f": 4}, "c": 5}, "g": 6}),
    ({"a": {"b": 1}}, {"a": 2}),
    ({"a": 2}, {"a": {"b": 1}}),
    ({}, {"x": [1, {"y": 2}]}),
])
def test_merger_matches_jax(onto, from_dict):
    snapshot = repr(onto), repr(from_dict)
    assert tmerger.deep_merge_dicts(onto, from_dict) == jmerger.deep_merge_dicts(onto, from_dict)
    assert (repr(onto), repr(from_dict)) == snapshot  # inputs not mutated
    assert tmerger.merge_dicts(onto, from_dict, {"z": 0}) == jmerger.merge_dicts(
        onto, from_dict, {"z": 0})
    for mod in (tmerger, jmerger):
        with pytest.raises(ValueError, match="2 or more"):
            mod.merge_dicts(onto)


def test_host_modules_import_without_pil_or_jax():
    """The ported modules import, and the codec and the visualisation run,
    with PIL, JAX and the JAX package blocked."""
    import subprocess
    import sys

    script = r"""
import sys
for name in ("PIL", "jax", "jaxlib", "flax", "optax", "cv2", "marie_tpu"):
    sys.modules[name] = None
import numpy as np
from marie_tpu_torch.document import TesseractOcrProcessor, GoogleVisionOcrProcessor
from marie_tpu_torch.registry import ModelRegistry
from marie_tpu_torch.utils import backoff, codec, merger, visualize
img = np.arange(60, dtype=np.uint8).reshape(6, 10)
assert (codec.base64_to_image(codec.encode_to_base64(img)) == img).all()
out = visualize.draw_ocr_overlay(img, {"words": [{"box": [1, 1, 4, 3], "text": "a",
                                                  "confidence": 0.5}]})
print(out.shape, TesseractOcrProcessor().is_available(), ModelRegistry.exists("zoo://none"))
"""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", script], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split() == ["(6,", "10,", "3)", "False", "False"]
