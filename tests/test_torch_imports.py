"""marie_tpu_torch and chip_smoke.py stand alone: they import neither JAX
(nor flax, orbax, PIL) nor anything of the JAX package."""

import os
import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "marie_tpu_torch"

_BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "orbax", "orbax.checkpoint", "PIL", "cv2"):
    sys.modules[name] = None  # any import of these now raises ImportError
assert not any(m == "marie_tpu" or m.startswith("marie_tpu.") for m in sys.modules)
import marie_tpu_torch
names = [m.name for m in pkgutil.walk_packages(marie_tpu_torch.__path__, "marie_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules if m == "marie_tpu" or m.startswith("marie_tpu."))
assert not leaked, leaked
print(len(names))
"""


def test_package_imports_with_jax_blocked():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.strip().splitlines()[-1]) >= 15


def test_no_jax_or_marie_tpu_imports_in_sources():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|flax|orbax|PIL|cv2|marie_tpu)(\.|\s|$)",
        re.M)
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    for path in files:
        text = path.read_text()
        assert not pattern.search(text), path
        assert "marie_tpu." not in re.sub(r"marie_tpu_torch", "", text).replace(
            "marie_tpu/", ""), path


def test_importing_the_package_builds_nothing():
    out = subprocess.run(
        [sys.executable, "-c",
         "import marie_tpu_torch.ocr.ocr_engine, marie_tpu_torch.ops.kernels._build as b;"
         "print(b._LIBS)"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "{}"


_NEW_MODULES = r"""
import sys
for name in ("jax", "jaxlib", "flax", "orbax", "orbax.checkpoint", "PIL", "cv2"):
    sys.modules[name] = None
from marie_tpu_torch.components.document_registration import DocumentBoundaryRegistration
from marie_tpu_torch.components.template_matching import (
    CompositeTemplateMatcher, DIMTemplateMatcher, NCCTemplateMatcher, OcrConditionedMatcher,
    VQNNFTemplateMatcher)
from marie_tpu_torch.models.boundary import BoundaryNet, warp_quad_to_page
from marie_tpu_torch.ops.nms import batched_nms, nms
from marie_tpu_torch.ops.box_ops import box_iou
reg = DocumentBoundaryRegistration(use_model=False, device="cpu")
m = NCCTemplateMatcher(device="cpu")
m.add_template("t", __import__("numpy").zeros((4, 4), "uint8"))
print(reg.model is None, len(m.match([__import__("numpy").full((16, 16), 255, "uint8")])))
"""


def test_registration_and_matching_import_with_jax_blocked():
    """The boundary and template-matching modules import and run (on the
    CPU) with JAX, flax, orbax, PIL and cv2 blocked."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", _NEW_MODULES], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split() == ["True", "0"]


def test_pipeline_and_embeddings_default_to_the_card():
    """The classification pipeline and the layout embeddings are the
    port's; the embeddings (like the heads the pipeline runs) are built on
    the card unless the caller asks for the CPU, and refuse where CUDA is
    absent rather than fall back."""
    import inspect

    import pytest
    import torch

    from marie_tpu_torch.embeddings import LayoutEmbeddingsModel
    from marie_tpu_torch.models.configs import LayoutLMConfig
    from marie_tpu_torch.pipe import ClassificationPipeline

    assert inspect.signature(LayoutEmbeddingsModel).parameters["device"].default == "cuda"
    assert callable(ClassificationPipeline.execute)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            LayoutEmbeddingsModel(LayoutLMConfig.tiny())


_DETECTORS = r"""
import sys
for name in ("jax", "jaxlib", "flax", "orbax", "orbax.checkpoint", "PIL", "cv2"):
    sys.modules[name] = None
import numpy as np
from marie_tpu_torch.boxes import (
    BoxProcessorTextFuseNet, BoxProcessorUlimDit, InkBoxProcessor)
from marie_tpu_torch.boxes.craft_box_processor import CC_STATS
from marie_tpu_torch.models.configs import TextFuseNetConfig, ViTConfig
from marie_tpu_torch.ops.roi_align import roi_align, roi_align_single
page = np.full((64, 48), 255, np.uint8)
page[20:30, 8:40] = 0
ink = InkBoxProcessor(device="cpu", bucket_spec=None)
print(len(ink.detect_words(page)[0]), sorted(CC_STATS))
"""


def test_detectors_import_with_jax_blocked():
    """The ink, DiT and TextFuseNet detectors, ROIAlign and the CC stats
    variants import (and the ink detector runs on the CPU) with JAX,
    flax, orbax, PIL and cv2 blocked."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", _DETECTORS], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split("\n")[0] == "1 ['reduce', 'reduce2', 'runs', 'runs_cc', 'sort']"


def test_detectors_default_to_the_card():
    """Each new detector, ROIAlign and the page-resident engine path run
    on the card unless the caller asks for the CPU, and refuse where CUDA
    is absent rather than fall back."""
    import inspect

    import pytest
    import torch

    from marie_tpu_torch.boxes import (
        BoxProcessorTextFuseNet, BoxProcessorUlimDit, InkBoxProcessor)
    from marie_tpu_torch.ops.roi_align import roi_align, roi_align_single

    entries = (InkBoxProcessor, BoxProcessorUlimDit, BoxProcessorTextFuseNet, roi_align,
               roi_align_single)
    for fn in entries:
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            InkBoxProcessor()
        with pytest.raises(RuntimeError):
            roi_align_single(torch.zeros(1, 4, 4), torch.zeros(1, 4))
