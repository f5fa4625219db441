"""Build the CUDA kernels under ``csrc/`` with ``nvcc`` and load them with
``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch headers),
so one source compiles in seconds.  The shared library lands in
``marie_tpu_torch/_build/`` under a name that carries a hash of its source
and flags: an edited source never loads a stale library.  Nothing builds
at import; :func:`load` builds on first use and :func:`build_all` builds
every source at once, one ``nvcc`` process per source, all started
together.

``nvcc`` runs with ``-Xptxas -v``: :data:`PTXAS` keeps, per source built
in this process, ptxas's lines on each kernel's registers, shared memory
and spills.

C-side contract: pointers and the stream are ``void*`` (``c_void_p``),
ints are ``int``; each entry point returns ``cudaGetLastError()`` after
its launch, and :func:`check` raises on a nonzero code.

Launch counts: each wrapper calls :func:`count_launch` where it launches
its kernel, which adds one to the wrapper's ``launches`` and to its
``launches_by_path`` entry for the path the calling thread is on
(:func:`launch_path`; ``"other"`` outside one).
"""

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Iterator, Optional

_PKG = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
    "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
#: {source: ptxas -v lines (kernel, registers, shared memory, spills)}
PTXAS: Dict[str, list] = {}


_COUNT_LOCK = threading.Lock()  # the engine launches kernels from two threads
_PATH = threading.local()


@contextlib.contextmanager
def launch_path(name: str) -> Iterator[None]:
    """Count the kernel launches this thread makes inside the block
    under ``name`` (the engine's paths: ``"fused"``, ``"overflow"``, and
    ``"heads"`` for the LayoutLM heads, chained or on their own)."""
    prev = getattr(_PATH, "name", None)
    _PATH.name = name
    try:
        yield
    finally:
        _PATH.name = prev


def count_launch(wrapper: Callable) -> None:
    """One launch of ``wrapper``'s kernel."""
    path = getattr(_PATH, "name", None) or "other"
    with _COUNT_LOCK:
        wrapper.launches += 1
        wrapper.launches_by_path[path] = wrapper.launches_by_path.get(path, 0) + 1


def reset_counts(*wrappers: Callable) -> None:
    """Set the wrappers' launch counts, in all and by path, to zero."""
    with _COUNT_LOCK:
        for wrapper in wrappers:
            wrapper.launches = 0
            wrapper.launches_by_path = {}


def sources() -> list:
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _lib_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every listed source (default: all of ``csrc/*.cu``) whose
    library is missing, in parallel.  Returns {name: seconds} of the
    builds that ran; raises with nvcc's output if one fails."""
    names = list(names) if names is not None else sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if out.is_file():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    took: Dict[str, float] = {}
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        PTXAS[name] = [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                       if "ptxas info" in ln and ("Compiling" in ln or "Used" in ln)
                       or "spill" in ln]
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return took


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.is_file():
                build_all([name])
            lib = ctypes.CDLL(str(path))
            lib.mt_error_string.argtypes = [ctypes.c_int]
            lib.mt_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a nonzero ``cudaError_t``."""
    if code != 0:
        msg = lib.mt_error_string(code).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {code}: {msg}")
