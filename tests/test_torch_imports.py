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
