"""RAFT consensus for replicated stateful executors (port of
``marie_tpu/serve/consensus/__init__.py``): ctypes bindings over the
port's copy of the native core, ``marie_tpu_torch/csrc/raft.cpp``.

The library is host C++ (no GPU code).  It builds with ``g++`` (flags
:data:`CXX_FLAGS`) from the port's source into ``marie_tpu_torch/_build/`` under a name that carries
a hash of the source and flags, at first use (:func:`build_library`), so
an edited source never loads a stale library; a server builds it before
it spawns workers (:func:`marie_tpu_torch.utils.kernel_cache.enable_persistent_cache`).
The wire (length-prefixed JSON over TCP) is the JAX copy's, so nodes of
both packages form one cluster.
"""

import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, List, Optional

from marie_tpu_torch.logging_core import MarieLogger

_PKG = Path(__file__).resolve().parents[2]
SOURCE = _PKG / "csrc" / "raft.cpp"
BUILD_DIR = _PKG / "_build"
# The library carries its own C++ runtime: libstdc++ and libgcc linked in
# statically and hidden (--exclude-libs), and -Bsymbolic binds its
# references to what it defines itself, so it shares no C++ code with the
# process.  Built with the plain flags, it crashed with SIGSEGV beside CUDA
# torch on some machines, at its first std::ostringstream (every RPC, the
# configuration); scripts/raft_link_check.py runs both builds there.
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared", "-pthread", "-static-libstdc++",
             "-static-libgcc", "-Wl,--exclude-libs,ALL", "-Wl,-Bsymbolic")

# the data pointer MUST be c_void_p: c_char_p converts to bytes cut at the
# first NUL (protobuf payloads hold NULs), and string_at then reads past it
_APPLY_CB = ctypes.CFUNCTYPE(
    None, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p)

_lib = None
_lib_lock = threading.Lock()


def library_path() -> Path:
    """Where the library of the current source and flags lives."""
    digest = hashlib.sha1(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libmarie_raft-{digest}.so"


def build_library() -> Optional[float]:
    """Compile the library when it is missing; returns the seconds the
    build took (None when it was there).  Raises with the compiler's
    output when the build fails."""
    import time

    out = library_path()
    if out.is_file():
        return None
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no C++ compiler (g++) to build the RAFT core")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCE.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build or load sees a whole file
    return time.perf_counter() - t0


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            build_library()
            lib = ctypes.CDLL(str(library_path()))
            vp, cp, i, ll = ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_longlong
            lib.raft_create.restype = vp
            lib.raft_create.argtypes = [cp, cp, _APPLY_CB, vp]
            lib.raft_start.argtypes = [vp]
            lib.raft_add_voter.argtypes = [vp, cp, cp]
            lib.raft_submit.restype = ll
            lib.raft_submit.argtypes = [vp, cp, i]
            lib.raft_snapshot.restype = ll
            lib.raft_snapshot.argtypes = [vp, cp, i]
            lib.raft_set_restore_cb.argtypes = [vp, _APPLY_CB, vp]
            for name in ("raft_log_length", "raft_snapshot_index", "raft_commit_index",
                         "raft_term"):
                getattr(lib, name).restype = ll
                getattr(lib, name).argtypes = [vp]
            lib.raft_state.argtypes = [vp]
            lib.raft_leader.argtypes = [vp, cp, i]
            lib.raft_get_configuration.argtypes = [vp, cp, i]
            lib.raft_shutdown.argtypes = [vp]
            _lib = lib
    return _lib


FOLLOWER, CANDIDATE, LEADER = 0, 1, 2


class RaftNode:
    """One consensus participant.

    ``apply_fn(data: bytes, index: int)`` runs for every committed log
    entry, in order, on the library's apply thread (the FSM);
    ``restore_fn`` likewise for an installed snapshot.  ``applied`` and
    ``restored`` keep every payload seen."""

    def __init__(self, node_id: str, bind_addr: str,
                 apply_fn: Optional[Callable[[bytes, int], None]] = None,
                 restore_fn: Optional[Callable[[bytes, int], None]] = None):
        self.logger = MarieLogger(f"raft/{node_id}")
        self.node_id = node_id
        self.bind_addr = bind_addr
        self.apply_fn = apply_fn
        self.restore_fn = restore_fn
        self.applied: List[bytes] = []
        self.restored: List[bytes] = []
        lib = _load()

        def _cb(data, length, index, _user):
            payload = ctypes.string_at(data, length)
            self.applied.append(payload)
            if self.apply_fn is not None:
                try:
                    self.apply_fn(payload, int(index))
                except Exception as ex:  # noqa: BLE001 — the native thread must not see it
                    self.logger.error(f"apply_fn failed at {index}: {ex!r}")

        def _rcb(data, length, index, _user):
            payload = ctypes.string_at(data, length) if length else b""
            self.restored.append(payload)
            if self.restore_fn is not None:
                try:
                    self.restore_fn(payload, int(index))
                except Exception as ex:  # noqa: BLE001
                    self.logger.error(f"restore_fn failed at {index}: {ex!r}")

        self._cb = _APPLY_CB(_cb)  # kept: the library holds the trampolines
        self._rcb = _APPLY_CB(_rcb)
        self._node = lib.raft_create(node_id.encode(), bind_addr.encode(), self._cb, None)
        lib.raft_set_restore_cb(self._node, self._rcb, None)
        self._lib = lib

    def start(self) -> "RaftNode":
        if self._lib.raft_start(self._node) != 0:
            raise OSError(f"raft node failed to bind {self.bind_addr}")
        return self

    def add_voter(self, node_id: str, addr: str) -> None:
        self._lib.raft_add_voter(self._node, node_id.encode(), addr.encode())

    def submit(self, data: bytes) -> int:
        """Append a log entry (leader only): its index, 0 on a follower."""
        return int(self._lib.raft_submit(self._node, data, len(data)))

    def snapshot(self, state: bytes) -> int:
        """Record ``state`` (the executor's snapshot blob) at last_applied
        and compact the log below it; a fresh follower catches up from the
        blob and the tail."""
        return int(self._lib.raft_snapshot(self._node, state, len(state)))

    @property
    def log_length(self) -> int:
        """Entries kept (the suffix after compaction)."""
        return int(self._lib.raft_log_length(self._node))

    @property
    def snapshot_index(self) -> int:
        return int(self._lib.raft_snapshot_index(self._node))

    @property
    def state(self) -> int:
        return int(self._lib.raft_state(self._node))

    @property
    def is_leader(self) -> bool:
        return self.state == LEADER

    @property
    def commit_index(self) -> int:
        return int(self._lib.raft_commit_index(self._node))

    @property
    def term(self) -> int:
        return int(self._lib.raft_term(self._node))

    @property
    def leader_id(self) -> str:
        buf = ctypes.create_string_buffer(256)
        self._lib.raft_leader(self._node, buf, 256)
        return buf.value.decode()

    def get_configuration(self) -> dict:
        buf = ctypes.create_string_buffer(16384)
        self._lib.raft_get_configuration(self._node, buf, 16384)
        return json.loads(buf.value.decode())

    def shutdown(self) -> None:
        if self._node is not None:
            self._lib.raft_shutdown(self._node)
            self._node = None

    def __enter__(self) -> "RaftNode":
        return self.start()

    def __exit__(self, *args) -> None:
        self.shutdown()
