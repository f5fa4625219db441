"""Device meshes (port of ``marie_tpu/parallel/mesh.py``).

A :class:`Mesh` is a grid of shape ``(D, M, ...)`` with named axes, in
one of two forms:

* **Local**: the torch devices this process drives (the JAX engine's
  single-controller ``mesh="local"``).  The serving path splits a page
  batch over its entries; :meth:`Mesh.run_each` runs one function per
  entry, each on a thread kept for that entry for the life of the
  process (cuDNN and cuBLAS keep their plans per thread).  An entry may
  name a device that another entry names too, as JAX's virtual CPU
  devices share one CPU, but only where the caller lists the devices:
  the default lists each visible card once.
* **World**: one ``torch.distributed`` rank per grid cell, each on its
  own device, with a process group per axis.  The training step and the
  pipeline, expert and sequence legs run on it, one rank a process.

:func:`create_mesh` gives the world form when a process group is
initialised (:func:`marie_tpu_torch.parallel.distributed.initialize_distributed`)
and no ``devices`` are given, else the local form.
"""

import concurrent.futures
import queue
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from marie_tpu_torch.ops.kernels._build import current_path, launch_path
from marie_tpu_torch.utils.device import DeviceLike, resolve_device


def _norm_device(device: DeviceLike) -> torch.device:
    """A device with its index: ``cuda`` is the current card."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A named grid of local devices or of world ranks (see the module
    note).  ``shape`` is ``{axis: size}`` in axis order, as JAX's."""

    def __init__(self, grid: np.ndarray, axis_names: Sequence[str], *,
                 world: bool = False, device: Optional[torch.device] = None,
                 staged: bool = False):
        grid = np.asarray(grid, dtype=object)
        if grid.ndim != len(axis_names):
            raise ValueError(f"a {grid.ndim}-d grid needs {grid.ndim} axis names, "
                             f"got {tuple(axis_names)}")
        self.axis_names = tuple(axis_names)
        self.is_world = world
        self.shape: Dict[str, int] = dict(zip(self.axis_names, grid.shape))
        self.size = int(grid.size)
        self._groups: Dict[str, object] = {}
        self._members: Dict[str, List[int]] = {}
        if world:
            import torch.distributed as dist

            self.ranks = grid
            self.devices = None
            self.rank = dist.get_rank()
            self.device = device
            #: collectives of a gloo world on CUDA tensors go through host
            #: memory (``parallel/collectives.py``)
            self.staged = staged
            where = np.argwhere(grid == self.rank)
            if len(where) != 1:
                raise ValueError(f"rank {self.rank} is not once in the mesh grid {grid.tolist()}")
            self.coords = tuple(int(c) for c in where[0])
            self._make_groups(dist)
        else:
            self.devices = grid
            self.ranks = None
            self.device = None
            self.staged = False

    def _make_groups(self, dist) -> None:
        """One process group per axis line; every rank creates every
        group, in one order, as ``new_group`` requires.  A line of one
        rank needs none, and a line of the whole world is the world."""
        grid = self.ranks
        for a, name in enumerate(self.axis_names):
            if grid.shape[a] == 1:
                continue
            lines = np.moveaxis(grid, a, -1).reshape(-1, grid.shape[a])
            for line in lines:
                ranks = [int(r) for r in line]
                if len(ranks) == dist.get_world_size():
                    group = dist.group.WORLD
                else:
                    group = dist.new_group(ranks)
                if self.rank in ranks:
                    self._groups[name] = group
                    self._members[name] = ranks

    # -- world form ------------------------------------------------------
    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (0 on an axis the mesh lacks)."""
        self._need_world()
        if axis not in self.shape:
            return 0
        return self.coords[self.axis_names.index(axis)]

    def group(self, axis: str):
        """The process group of this rank's line along ``axis`` (None for
        an axis of one rank)."""
        self._need_world()
        return self._groups.get(axis)

    def members(self, axis: str) -> List[int]:
        """The world ranks of this rank's line along ``axis``, in axis order."""
        self._need_world()
        return self._members.get(axis, [self.rank])

    def _need_world(self) -> None:
        if not self.is_world:
            raise ValueError("a local mesh has no ranks: this needs a world mesh")

    # -- local form ------------------------------------------------------
    @property
    def local_devices(self) -> List[torch.device]:
        """The entries' devices, flat in grid order (a device may repeat)."""
        if self.is_world:
            raise ValueError("a world mesh has one device per rank: use mesh.device")
        return list(self.devices.reshape(-1))

    def run_each(self, fn: Callable[[int, torch.device], object]) -> List[object]:
        """``[fn(i, device_i)]`` over the entries, each call on the entry's
        kept thread, all at once; the caller's launch path and grad mode
        hold in each.  Raises the first entry's error once every call has
        ended."""
        path, grad = current_path(), torch.is_grad_enabled()

        def call(i, dev):
            with torch.set_grad_enabled(grad):
                if path is None:
                    return fn(i, dev)
                with launch_path(path):
                    return fn(i, dev)

        futs = [_entry_thread(i, dev).submit(call, i, dev)
                for i, dev in enumerate(self.local_devices)]
        concurrent.futures.wait(futs)
        return [f.result() for f in futs]

    def __repr__(self) -> str:
        form = "world" if self.is_world else "local"
        return f"Mesh({form}, {self.shape})"


class _EntryThread:
    """The thread kept for one (entry, device) of local meshes: it takes
    calls from a queue, in order, for the life of the process."""

    def __init__(self, index: int, device: torch.device):
        self.device = device
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name=f"mesh-entry-{index}-{device}")
        self._thread.start()

    def submit(self, fn, *args) -> concurrent.futures.Future:
        fut: concurrent.futures.Future = concurrent.futures.Future()
        self._q.put((fut, fn, args))
        return fut

    def _serve(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)  # the current device is per thread
        while True:
            fut, fn, args = self._q.get()
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                fut.set_result(fn(*args))
            except BaseException as exc:  # noqa: BLE001 — raised in the caller
                fut.set_exception(exc)


_ENTRY_LOCK = threading.Lock()
_ENTRIES: Dict[Tuple[int, str], _EntryThread] = {}


def _entry_thread(index: int, device: torch.device) -> _EntryThread:
    key = (index, str(device))
    with _ENTRY_LOCK:
        if key not in _ENTRIES:
            _ENTRIES[key] = _EntryThread(index, device)
        return _ENTRIES[key]


def visible_devices() -> List[torch.device]:
    """Every visible card once (raises without CUDA, as the port's entry
    points do where the CPU is not asked for)."""
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def create_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("data", "model"),
    devices: Optional[Sequence[DeviceLike]] = None,
) -> Mesh:
    """Build a mesh over the available devices, or over the world.

    ``shape=(D, M)``: D-way data parallel x M-way model parallel; the
    default is all data parallel (D = the device or rank count, M = 1).
    ``shape`` may have any length that matches ``axis_names``.  Without
    ``devices`` and with a process group initialised, the grid holds the
    world's ranks in order; else it holds ``devices`` (default: every
    visible card once).  A shape that does not cover the devices or ranks
    raises."""
    world = devices is None and _world_initialised()
    if world:
        import torch.distributed as dist

        from marie_tpu_torch.parallel import distributed as _dist

        items: list = list(range(dist.get_world_size()))
    else:
        items = [_norm_device(d) for d in (devices if devices is not None
                                           else visible_devices())]
    n = len(items)
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} does not match the axes {tuple(axis_names)}")
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} does not cover {n} devices")
    grid = np.empty(n, dtype=object)
    grid[:] = items
    grid = grid.reshape(shape)
    if world:
        return Mesh(grid, axis_names, world=True, device=_dist.world_device(),
                    staged=_dist.world_staged())
    return Mesh(grid, axis_names)


def default_mesh() -> Mesh:
    return create_mesh()


def _world_initialised() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()
