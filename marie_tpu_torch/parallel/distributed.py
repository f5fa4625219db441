"""Multi-process initialisation on ``torch.distributed`` (port of
``marie_tpu/parallel/distributed.py``), and :func:`spawn_world`, which
starts a world of ranks on this host and runs one function in each.

:func:`initialize_distributed` reads the JAX package's environment
(``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
``JAX_PROCESS_ID``), so a deployment's settings carry over, or
torchrun's (``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` /
``RANK``).  The backend is NCCL where the host's ranks sit on distinct
cards, and gloo on the CPU or where ranks share a card (NCCL refuses two
ranks on one GPU).  On a gloo world with CUDA tensors every collective
goes through host memory, explicitly
(:mod:`marie_tpu_torch.parallel.collectives`); the world says so
(:func:`world_staged`) and logs it at start.
"""

import datetime
import multiprocessing
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from marie_tpu_torch.logging_core import MarieLogger
from marie_tpu_torch.utils.device import DeviceLike, resolve_device

logger = MarieLogger("distributed")

#: a rank that does not answer within this fails the collective
TIMEOUT_S = 60.0
_STATE: Dict[str, Any] = {"device": None, "staged": False}


def _rank_device(device: DeviceLike, rank: int) -> torch.device:
    """This rank's device: the CPU, or card ``LOCAL_RANK`` (else the
    rank) modulo the visible cards."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device: DeviceLike = "cuda",
    backend: Optional[str] = None,
    timeout_s: float = TIMEOUT_S,
) -> bool:
    """Join the process group (a no-op without a coordinator).

    ``coordinator_address`` (else ``JAX_COORDINATOR_ADDRESS``) is
    ``host:port`` (a TCP rendezvous) or an init URL (``tcp://...``,
    ``file://...``); with neither, torchrun's ``MASTER_ADDR`` and
    ``WORLD_SIZE`` are read.  ``device`` is where this rank computes:
    ``"cuda"`` is card ``LOCAL_RANK`` (else the rank) modulo the visible
    cards.  ``backend`` defaults to NCCL where the host's ranks
    (``LOCAL_WORLD_SIZE``, else the world) fit on distinct cards, else
    gloo.  Collectives time out after ``timeout_s``, so a lost rank fails
    the run instead of hanging it.  Returns True when the process joined
    a world."""
    import torch.distributed as dist

    env = os.environ
    address = coordinator_address or env.get("JAX_COORDINATOR_ADDRESS")
    if address:
        init_method = address if "://" in address else f"tcp://{address}"
        world = num_processes or int(env.get("JAX_NUM_PROCESSES", "1"))
        rank = process_id if process_id is not None else int(env.get("JAX_PROCESS_ID", "0"))
    elif env.get("MASTER_ADDR") and env.get("WORLD_SIZE"):
        init_method = "env://"
        world = num_processes or int(env["WORLD_SIZE"])
        rank = process_id if process_id is not None else int(env.get("RANK", "0"))
    else:
        return False
    if dist.is_initialized():
        raise RuntimeError("this process already joined a world")
    dev = _rank_device(device, rank)
    if backend is None:
        local_world = int(env.get("LOCAL_WORLD_SIZE", world))
        distinct = dev.type == "cuda" and local_world <= torch.cuda.device_count()
        backend = "nccl" if distinct else "gloo"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("an NCCL world computes on cards, not on the CPU")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kwargs = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    _STATE["device"] = dev
    _STATE["staged"] = backend == "gloo" and dev.type == "cuda"
    logger.info(f"joined a world: rank {rank}/{world} on {dev}, backend {backend}"
                + (", collectives staged through host memory" if _STATE["staged"] else ""))
    return True


def world_device() -> torch.device:
    """The device this rank computes on."""
    if _STATE["device"] is None:
        raise RuntimeError("no world: call initialize_distributed first")
    return _STATE["device"]


def world_staged() -> bool:
    """True on a gloo world whose ranks compute on cards."""
    return bool(_STATE["staged"])


def shutdown_distributed() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    _STATE.update(device=None, staged=False)


def host_shard_bounds(total: int) -> tuple:
    """[start, end) of this process's shard of a stream of ``total``
    items (one process alone takes all)."""
    import torch.distributed as dist

    n, i = (dist.get_world_size(), dist.get_rank()) if dist.is_initialized() else (1, 0)
    per = -(-total // n)
    return min(i * per, total), min((i + 1) * per, total)


def _rank_main(fn, args, rank, n, init_method, device, env, backend, results):
    """One rank of :func:`spawn_world`: its environment, the world, the
    function; (rank, ok, result or traceback) to the parent."""
    try:
        os.environ.update(env(rank) if callable(env) else (env or {}))
        torch.set_num_threads(1)
        if init_method is not None:
            initialize_distributed(init_method, n, rank, device=device, backend=backend)
        out = fn(*args)
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 — reported to the parent
        results.put((rank, False, traceback.format_exc()))
    finally:
        try:
            shutdown_distributed()
        except Exception:  # noqa: BLE001 — the result is already sent
            pass


def spawn_world(fn: Callable, n: int, args: Sequence = (), *, device: DeviceLike = "cuda",
                backend: Optional[str] = None, init: bool = True,
                env: Optional[Any] = None, timeout_s: float = 120.0) -> List[Any]:
    """Run ``fn(*args)`` in each of ``n`` fresh processes (``spawn``),
    each a rank of one world joined through a file store in a temporary
    directory (with ``init=False`` the function joins by itself, e.g.
    from ``env``: a dict, or ``rank -> dict``, of environment variables
    set before it runs).  ``fn`` and ``args`` must pickle, and ``fn``'s
    module is imported in every rank.  Returns the ranks' results in rank
    order.  A rank that fails, or a world that has not ended within
    ``timeout_s``, kills every rank and raises."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="marie-world-") as tmp:
        init_method = f"file://{os.path.join(tmp, 'store')}" if init else None
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, tuple(args), r, n, init_method, str(device), env,
                                   backend, results))
                 for r in range(n)]
        for p in procs:
            p.start()
        got: Dict[int, Any] = {}
        deadline = time.monotonic() + timeout_s
        try:
            while len(got) < n:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"world of {n}: ranks {sorted(set(range(n)) - set(got))} "
                                       f"did not end within {timeout_s} s")
                try:
                    rank, ok, out = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"world of {n}: rank {dead[0]} died with exit code "
                                           f"{procs[dead[0]].exitcode}")
                    continue
                if not ok:
                    raise RuntimeError(f"world of {n}: rank {rank} failed:\n{out}")
                got[rank] = out
            for p in procs:
                p.join(timeout=max(deadline - time.monotonic(), 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(5)
    return [got[r] for r in range(n)]
