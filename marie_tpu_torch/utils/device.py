"""Device selection and the float32 precision of convolutions and
matmuls."""

import contextlib
import subprocess
import threading
from typing import Callable, Iterator, Optional, Tuple, TypeVar, Union

import torch

DeviceLike = Union[str, torch.device, None]
T = TypeVar("T")


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  Raises when CUDA is asked for and absent — a run on the card
    never falls back to the CPU silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def resolve_mesh(mesh, device: DeviceLike = "cuda"):
    """The JAX engine's ``mesh`` argument on the port: ``None`` is no mesh;
    ``"local"`` is a local :class:`~marie_tpu_torch.parallel.mesh.Mesh`
    over every visible card where there are two or more, and no mesh on
    the CPU or on one card (as ``marie_tpu/ocr/ocr_engine.py`` builds
    one only over several local devices); a port ``Mesh`` is taken as it
    is.  Anything else raises ``TypeError``."""
    from marie_tpu_torch.parallel.mesh import Mesh, create_mesh, visible_devices

    if mesh is None or isinstance(mesh, Mesh):
        return mesh
    if isinstance(mesh, str) and mesh == "local":
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cpu" or torch.cuda.device_count() < 2:
            return None
        return create_mesh(axis_names=("pages",), devices=visible_devices())
    raise TypeError(f"mesh must be None, 'local' or a marie_tpu_torch Mesh, "
                    f"got {type(mesh).__name__}")


def set_parity_precision() -> None:
    """Full float32 for matmuls and convolutions (TF32 off for both): a
    float32 comparison against a reference must not run in TF32, which
    cuDNN convolutions use by default."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _precision_flags():
    """(read, write) of the process-global float32 precision flags of
    cuDNN convolutions (and RNNs, kept equal to them so that torch's
    legacy ``cudnn.allow_tf32`` stays readable) and of cuBLAS matmuls:
    the per-operation ``fp32_precision`` settings where torch has them,
    else the legacy ``allow_tf32`` flags.  A value is ``"tf32"`` or
    ``"ieee"`` (``"none"`` where torch left a setting to its parent)."""
    b = torch.backends
    if hasattr(b.cudnn, "conv"):
        objs = (b.cudnn.conv, b.cudnn.rnn, b.cuda.matmul)

        def read() -> Tuple[str, ...]:
            return tuple(o.fp32_precision for o in objs)

        def write(values) -> None:
            for o, v in zip(objs, values):
                o.fp32_precision = v

        return read, write, len(objs)
    legacy = (b.cudnn, b.cuda.matmul)

    def read_legacy() -> Tuple[str, ...]:
        return tuple("tf32" if o.allow_tf32 else "ieee" for o in legacy)

    def write_legacy(values) -> None:
        for o, v in zip(legacy, values):
            o.allow_tf32 = v == "tf32"

    return read_legacy, write_legacy, len(legacy)


class _SharedHold:
    """Process-global flags held for blocks of work.

    The flags are process-global and blocks run on several threads at
    once (the engine's device thread and the collect; a trainer's loop
    thread), so blocks that want the same value share one hold: the first
    saves the flags and sets them, later ones (on any thread, or nested
    in one) join it, and the last to leave restores what the first found.
    A block that wants another value waits until no block holds the
    flags; nested in a block of another value on its own thread, it
    raises.  A save and restore per block would let two blocks on two
    threads restore each other's values out of order."""

    def __init__(self, read: Callable[[], tuple], write: Callable[[tuple], None]):
        self._read, self._write = read, write
        self._cond = threading.Condition()
        self._holders = 0
        self._value: Optional[tuple] = None
        self._saved: Optional[tuple] = None
        self._local = threading.local()

    @contextlib.contextmanager
    def hold(self, value: tuple) -> Iterator[None]:
        held = getattr(self._local, "value", None)
        if held is not None and held != value:
            raise RuntimeError(f"a block holding {held} cannot nest one holding {value}")
        with self._cond:
            self._cond.wait_for(lambda: self._holders == 0 or self._value == value)
            if self._holders == 0:
                self._saved = self._read()
                self._write(value)
                self._value = value
            self._holders += 1
        self._local.value = value
        try:
            yield
        finally:
            self._local.value = held
            with self._cond:
                self._holders -= 1
                if self._holders == 0:
                    self._write(self._saved)
                    self._value = self._saved = None
                    self._cond.notify_all()


_FLOAT32 = _SharedHold(lambda: _precision_flags()[0](), lambda v: _precision_flags()[1](v))


def float32_precision(allow_tf32: bool = False):
    """Context manager: cuDNN convolutions and cuBLAS matmuls on float32
    inputs run in full float32 (``allow_tf32=False``, the JAX CPU
    reference's precision) or in TF32 inside the block, whatever the
    process-global flags say; the block leaves the flags as it found
    them.  Other threads see the block's setting while it runs."""
    return _FLOAT32.hold(("tf32" if allow_tf32 else "ieee",) * _precision_flags()[2])


#: the candidates cuDNN times for a shape, its heuristics' first ones: at
#: the CRNN's float32 shapes the first is an FFT algorithm 2.7x slower than
#: the second or third, and trying all ten took 21 s (an H100; PERF.md)
CUDNN_BENCHMARK_LIMIT = 3


def _read_cudnn_benchmark() -> tuple:
    cudnn = torch.backends.cudnn
    return cudnn.benchmark, cudnn.benchmark_limit


def _write_cudnn_benchmark(values: tuple) -> None:
    cudnn = torch.backends.cudnn
    cudnn.benchmark, cudnn.benchmark_limit = values


_CUDNN_BENCHMARK = _SharedHold(_read_cudnn_benchmark, _write_cudnn_benchmark)


def cudnn_benchmark():
    """Context manager: inside the block cuDNN times the first
    CUDNN_BENCHMARK_LIMIT algorithms its heuristics rank for each new
    convolution shape (among those the float32 precision allows) and
    keeps the fastest (``torch.backends.cudnn.benchmark``).  Blocks that
    overlap, on one thread or several, share one hold of the
    process-global flags: the last to leave restores what the first
    found.  For a loop of one fixed shape, where the heuristics' first
    choice is slow."""
    return _CUDNN_BENCHMARK.hold((True, CUDNN_BENCHMARK_LIMIT))


def on_own_thread(fn: Callable[[], T]) -> T:
    """``fn()`` run on a new thread and joined; its exception re-raised
    here.  cuDNN keeps the algorithm it chose for a convolution shape per
    thread, whatever :func:`cudnn_benchmark` says later: a loop that
    wants its shapes timed runs where no earlier call chose for them."""
    out = {}

    def target():
        try:
            out["value"] = fn()
        except BaseException as e:  # re-raised on the caller's thread
            out["error"] = e

    worker = threading.Thread(target=target, name="own-cudnn-plans")
    worker.start()
    worker.join()
    if "error" in out:
        raise out["error"]
    return out["value"]


def card_name_and_power_limit() -> Optional[str]:
    """``name, power.limit`` of the first card as nvidia-smi prints them,
    or None where nvidia-smi is absent."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    return lines[0] if lines else None
