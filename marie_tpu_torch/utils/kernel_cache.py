"""The kernel build cache (counterpart of ``marie_tpu/utils/jax_cache.py``).

The JAX package keeps XLA's compiled programs in a persistent cache so
that a process does not compile them again.  The port compiles nothing at
run time but its hand-written kernels: each ``csrc/*.cu`` builds once with
``nvcc`` into a library whose name carries a hash of its source and flags
(:mod:`marie_tpu_torch.ops.kernels._build`), and every later process loads
that library.  :func:`enable_persistent_cache` builds the missing ones
before a server spawns its workers, so that two workers starting together
never both run ``nvcc``; it builds the RAFT core too (host C++, ``g++``;
:mod:`marie_tpu_torch.serve.consensus`), so that the replicas of a
stateful deployment never race to compile it.
"""

from pathlib import Path
from typing import Dict


def default_cache_dir() -> Path:
    """Where the kernel libraries persist (``_build.BUILD_DIR``)."""
    from marie_tpu_torch.ops.kernels._build import BUILD_DIR

    return BUILD_DIR


def enable_persistent_cache() -> Dict[str, float]:
    """Build every kernel whose library is missing, one ``nvcc`` a source,
    all at once, and the RAFT core; returns {source: seconds} of the
    builds that ran (empty when every library was there).  Raises where
    ``nvcc`` or ``g++`` is missing or a build fails."""
    from marie_tpu_torch.ops.kernels import _build
    from marie_tpu_torch.serve.consensus import build_library

    missing = [name for name in _build.sources() if not _build._lib_path(name).is_file()]
    took = _build.build_all(missing) if missing else {}
    raft_s = build_library()
    if raft_s is not None:
        took["raft"] = raft_s
    return took
