"""Device selection and the float32 precision of convolutions and
matmuls."""

import contextlib
import subprocess
import threading
from typing import Iterator, Optional, Tuple, Union

import torch

DeviceLike = Union[str, torch.device, None]


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


class _Float32Precision:
    """Holds the float32 precision flags for blocks of work.

    The flags are process-global and the engine runs blocks on two
    threads at once (the device thread and the collect), so blocks that
    want the same precision share one hold: the first saves the flags and
    sets them, the last restores what the first found.  A block that
    wants the other precision waits until no block holds them."""

    def __init__(self):
        self._cond = threading.Condition()
        self._holders = 0
        self._mode: Optional[str] = None
        self._saved: Optional[Tuple[str, ...]] = None
        self._local = threading.local()

    @contextlib.contextmanager
    def hold(self, mode: str) -> Iterator[None]:
        held = getattr(self._local, "mode", None)
        if held is not None and held != mode:
            raise RuntimeError(f"a {held} precision block cannot nest a {mode} one")
        read, write, n = _precision_flags()
        with self._cond:
            self._cond.wait_for(lambda: self._holders == 0 or self._mode == mode)
            if self._holders == 0:
                self._saved = read()
                write((mode,) * n)
                self._mode = mode
            self._holders += 1
        self._local.mode = mode
        try:
            yield
        finally:
            self._local.mode = held
            with self._cond:
                self._holders -= 1
                if self._holders == 0:
                    write(self._saved)
                    self._mode = self._saved = None
                    self._cond.notify_all()


_FLOAT32 = _Float32Precision()


def float32_precision(allow_tf32: bool = False):
    """Context manager: cuDNN convolutions and cuBLAS matmuls on float32
    inputs run in full float32 (``allow_tf32=False``, the JAX CPU
    reference's precision) or in TF32 inside the block, whatever the
    process-global flags say; the block leaves the flags as it found
    them.  Other threads see the block's setting while it runs."""
    return _FLOAT32.hold("tf32" if allow_tf32 else "ieee")


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
