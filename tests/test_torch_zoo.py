"""The port's zoo (``torch_zoo/``) against the JAX package's on the CPU:
the ``.npz`` tree format, each committed tree against its orbax
checkpoint after the serving casts, JAX processors built from either
holding the same bits, the components' zoo loaders against the JAX
heads, the shipped pages, truth and golden, and the registry's engines
on two shipped pages against their golden.

The golden (``scripts/export_torch_zoo.py``) is the JAX engine's output
in the serving configuration on one 16-page group; here the port runs
two pages with the registry's own settings, so it is held to the limits
``chip_smoke.py`` holds the card to, not to equality: matched words with
equal text >= 0.99, recall within 0.005 of the golden's, CER at most the
golden's + 0.005, equal page labels on pages whose words all agree."""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from marie_tpu.registry.checkpoints import load_params as load_orbax
from marie_tpu_torch.check import agreement, compare_results, truth_pages
from marie_tpu_torch.registry.checkpoints import load_params, save_params
from marie_tpu_torch.registry.zoo import ZOO_DIR, open_zoo_json, zoo_checkpoint, zoo_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORBAX = os.path.join(REPO, "model_zoo")
SERVING = [("craft-s2d2-synth", True), ("trocr-fast3g2d6ov-synth", True),
           ("layout-classifier-chain", False), ("layout-indexer-chain", False)]


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: np.asarray(tree)}


def _bf16(x):
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


@pytest.fixture(scope="module")
def shipped():
    with np.load(os.path.join(ZOO_DIR, "pages.npz")) as data:
        pages = {k: data[k] for k in data.files}
    with open_zoo_json("truth") as f:
        truth = json.load(f)
    with open_zoo_json("golden") as f:
        golden = json.load(f)
    return pages, truth, golden


def test_npz_round_trip(tmp_path):
    """float32 and int leaves come back as they went; bfloat16 storage
    rounds to nearest even exactly as ``astype(bfloat16)`` and widens
    back exactly."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((64, 33)) * 10.0 ** rng.integers(-30, 30, (64, 33))).astype(np.float32)
    special = np.asarray([0.0, -0.0, 1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, -(1.0 + 2.0 ** -8),
                          3.4e38, 1e-40, -1e-45, 65504.0], np.float32)
    tree = {"params": {"conv": {"kernel": x, "bias": special}, "emb": {"embedding": x[:4]}},
            "batch_stats": {"bn": {"mean": x[0], "var": np.abs(x[1])}},
            "step": np.asarray(7, np.int32)}
    save_params(tree, str(tmp_path / "a.npz"))
    back = _flat(load_params(str(tmp_path / "a.npz")))
    want = _flat(tree)
    assert back.keys() == want.keys()
    for k in want:
        assert back[k].dtype == want[k].dtype
        np.testing.assert_array_equal(back[k], want[k])
    save_params(tree, str(tmp_path / "b.npz"), dtype="bfloat16")
    half = _flat(load_params(str(tmp_path / "b.npz")))
    for k in want:
        if want[k].dtype == np.float32:
            assert half[k].dtype == np.float32
            np.testing.assert_array_equal(half[k].view(np.uint32), _bf16(want[k]).view(np.uint32))
        else:
            np.testing.assert_array_equal(half[k], want[k])
    with pytest.raises(ValueError):
        save_params({"a/b": x}, str(tmp_path / "c.npz"))
    with pytest.raises(ValueError):
        save_params({"a": np.asarray([np.nan], np.float32)}, str(tmp_path / "d.npz"),
                    dtype="bfloat16")


@pytest.mark.parametrize("name,bf16", SERVING)
def test_committed_tree_equals_orbax(name, bf16):
    """Each committed tree is its orbax checkpoint after the serving cast
    (bfloat16 for CRAFT and TrOCR, none for the float32 heads), to the bit."""
    want = _flat(jax.device_get(load_orbax(os.path.join(ORBAX, name))))
    got = _flat(zoo_params(name))
    assert got.keys() == want.keys()
    for k, w in want.items():
        w = _bf16(w) if bf16 else w
        assert got[k].dtype == np.float32 and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k].view(np.uint32), w.view(np.uint32))


def test_jax_processors_from_npz_equal_orbax():
    """A JAX processor in the serving configuration holds the same bits
    whether its tree came from orbax or from the port's .npz."""
    from marie_tpu.boxes.craft_box_processor import BoxProcessorCraft
    from marie_tpu.document.trocr_ocr_processor import TrOcrProcessor
    from marie_tpu.models.configs import CraftConfig, TrOCRConfig

    def bits(tree):
        return {k: v.view(np.uint16) for k, v in _flat(jax.device_get(tree)).items()}

    for make, name, attr in (
        (lambda t: BoxProcessorCraft(config=CraftConfig.fast_s2d2(), variables=t,
                                     param_dtype="bfloat16"), "craft-s2d2-synth", "variables"),
        (lambda t: TrOcrProcessor(config=TrOCRConfig.fast_v3_g2_d6(), params=t,
                                  param_dtype="bfloat16"), "trocr-fast3g2d6ov-synth", "params"),
    ):
        a = bits(getattr(make(load_orbax(os.path.join(ORBAX, name))), attr))
        b = bits(getattr(make(zoo_params(name)), attr))
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
        del a, b


def test_zoo_loaders_match_jax(shipped):
    """``from_zoo_chain`` builds the trained heads (scores within 1e-4 of
    the JAX heads on two shipped pages' truth words); trees the zoo lacks
    give None."""
    from marie_tpu.components.base import PageInput as JaxPageInput
    from marie_tpu.components.document_classifier import (
        LayoutDocumentClassifier as JaxClassifier,
    )
    from marie_tpu.components.document_indexer import LayoutDocumentIndexer as JaxIndexer
    from marie_tpu_torch.components.base import PageInput
    from marie_tpu_torch.components.document_classifier import LayoutDocumentClassifier
    from marie_tpu_torch.components.document_indexer import LayoutDocumentIndexer

    _, truth, _ = shipped
    words = [[t for t, _ in page] for page in truth["pages"][:2]]
    boxes = [[b for _, b in page] for page in truth["pages"][:2]]
    pages = [PageInput(w, b, page_size=(768, 1024)) for w, b in zip(words, boxes)]
    jpages = [JaxPageInput(w, b, page_size=(768, 1024)) for w, b in zip(words, boxes)]

    cls = LayoutDocumentClassifier.from_zoo_chain(device="cpu")
    assert cls.zoo_name == "layout-classifier-chain"
    got, want = cls.predict(pages), JaxClassifier.from_zoo_chain().predict(jpages)
    assert [p["label"] for p in got] == [p["label"] for p in want]
    np.testing.assert_allclose([list(p["scores"].values()) for p in got],
                               [list(p["scores"].values()) for p in want], rtol=0, atol=1e-4)
    ner = LayoutDocumentIndexer.from_zoo_chain(device="cpu")
    got, want = ner.index(pages), JaxIndexer.from_zoo_chain().index(jpages)
    for g, w in zip(got, want):
        assert [(e["label"], e["text"]) for e in g["entities"]] == [
            (e["label"], e["text"]) for e in w["entities"]]
        np.testing.assert_allclose([e["score"] for e in g["entities"]],
                                   [e["score"] for e in w["entities"]], rtol=0, atol=1e-4)

    assert zoo_checkpoint("layout-classifier-synth") is None and zoo_params("nope") is None
    assert LayoutDocumentClassifier.from_zoo(device="cpu") is None
    assert LayoutDocumentIndexer.from_zoo(device="cpu") is None


def test_shipped_pages_truth_and_golden(shipped):
    """Pages, forms, truth and golden agree with each other, and the
    golden holds every truth word (recall 1.0 at IoU 0.4, CER 0)."""
    from marie_tpu_torch.boxes.craft_box_processor import is_grayscale

    pages, truth, golden = shipped
    assert pages["pages"].shape == (16, 1024, 768) and pages["pages"].dtype == np.uint8
    assert pages["rgb"].shape == (1024, 768, 3) and not is_grayscale(pages["rgb"][None])
    assert pages["oversize"].shape == (3300, 2550)
    assert len(truth["pages"]) == len(golden["pages"]) == 16
    report = compare_results(truth_pages(truth["pages"], [(1024, 768)] * 16), golden["pages"],
                             iou_threshold=0.4)
    assert report["detection"]["recall"] == 1.0 and report["recognition"]["cer"] == 0.0
    assert all("classification" in p for p in golden["pages"])
    assert set(golden["modes"]) == {"raw_line", "word", "multiline"}
    assert [r["id"] for r in golden["regions"]["result"]] == [
        r["id"] for r in golden["regions"]["request"]]


@pytest.mark.parametrize("name", ["default", "chained"])
def test_known_engines_on_shipped_pages_against_golden(shipped, name):
    """The registry's engines load every tree and, on two shipped pages,
    stay within the golden's limits."""
    from marie_tpu_torch.ocr.util import get_known_ocr_engines

    pages, truth, golden = shipped
    engine = get_known_ocr_engines("cpu", name)[name]
    assert all(engine.trained.values()) and len(engine.trained) == (2 if name == "default" else 4)
    got = engine.extract(list(pages["pages"][:2]))
    want = golden["pages"][:2]
    agree = agreement(want, got)
    assert agree["words"] >= 0.99
    assert agree["label_pages"] == []
    assert agree["ner_pages"] == []
    gold = truth_pages(truth["pages"][:2], [(1024, 768)] * 2)
    mine, theirs = (compare_results(gold, r, iou_threshold=0.4) for r in (got, want))
    assert abs(mine["detection"]["recall"] - theirs["detection"]["recall"]) <= 0.005
    assert mine["recognition"]["cer"] <= theirs["recognition"]["cer"] + 0.005


def test_chained_engine_ner_on_box_equal_pages(shipped):
    """The engine in the golden's configuration (``bench.py``'s serving
    settings with the chained heads) on shipped pages 4 and 6 against the
    golden: the words' text equal, and the NER labels equal on every page
    whose boxes all equal the golden's.  The CPU bf16 CRAFT rounds where
    XLA's does (models/craft.py), but its convolutions sum in another
    order, which moves a box on some pages (PERF.md, fault 2): page 4's
    boxes equal the golden's; page 6 moves one box and with it NER
    labels."""
    from marie_tpu_torch.components.document_classifier import LayoutDocumentClassifier
    from marie_tpu_torch.components.document_indexer import LayoutDocumentIndexer
    from marie_tpu_torch.ocr.ocr_engine import PipelineOcrEngine
    from marie_tpu_torch.ocr.util import craft_box_processor, trocr_processor

    pages, _, golden = shipped
    engine = PipelineOcrEngine(
        craft_box_processor(256, cc_runs=32, device="cpu"),
        trocr_processor(device="cpu", batch_sizes=(32, 128, 256)),
        upload_format="u2", compact_slots=160, page_fuse_batch=16,
        classifier=LayoutDocumentClassifier.from_zoo_chain(device="cpu"),
        indexer=LayoutDocumentIndexer.from_zoo_chain(device="cpu"))
    got = engine.extract([pages["pages"][4], pages["pages"][6]])
    agree = agreement([golden["pages"][4], golden["pages"][6]], got)
    assert agree["words"] == 1.0
    assert 0 in agree["box_pages"]
    assert agree["ner_pages"] == []
