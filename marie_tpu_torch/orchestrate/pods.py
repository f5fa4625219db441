"""Pod (port of ``marie_tpu/orchestrate/pods.py``): one serving process.

``Pod("worker", uses=..., uses_with=..., protocol="http").start()``
spawns a child (the ``spawn`` context: the parent may hold a CUDA context,
which a forked child cannot use) that builds a
:class:`WorkerRequestHandler` and an :class:`AsyncNewLoopRuntime`, binds
its port and signals readiness; the parent waits for that.  SIGTERM
stops the child gracefully (server shutdown, then the executor's
``close``).  The child inherits ``CUDA_VISIBLE_DEVICES`` and the rest of
the environment; the executor's device comes from ``uses_with``, and
``uses`` travels as a class (pickled by reference) or a dotted path.
The CUDA kernels the child launches load from the libraries the parent
built (``ops/kernels/_build.py`` names them by a hash of their source).

The ``"gateway"`` and ``"head"`` kinds, RAFT replication and discovery
wait for the gRPC slice.
"""

import multiprocessing
import time
from typing import Any, Dict

from marie_tpu_torch.excepts import RuntimeFailToStart, not_ported
from marie_tpu_torch.logging_core import MarieLogger

#: how long :meth:`Pod.start` waits for the child's readiness by default
READY_TIMEOUT_S = 60.0


def _pod_main(kind: str, kwargs: Dict[str, Any], ready_event, port_value) -> None:
    """The child's entry point: serve until SIGTERM/SIGINT."""
    import asyncio
    import signal

    from marie_tpu_torch.serve.runtimes.asyncio_runtime import AsyncNewLoopRuntime
    from marie_tpu_torch.serve.runtimes.worker.request_handling import WorkerRequestHandler

    if kwargs.get("auth_keys"):
        # a spawned child starts with no keys: load the parent's
        from marie_tpu_torch.auth import APIKeyManager

        APIKeyManager.from_config(kwargs["auth_keys"])

    handler = WorkerRequestHandler(
        uses=kwargs.get("uses"),
        uses_with=kwargs.get("uses_with"),
        name=kwargs.get("name", "executor"),
        workspace=kwargs.get("workspace"),
        job_kv_path=kwargs.get("job_kv_path"),
    )
    runtime = AsyncNewLoopRuntime(
        handler,
        protocol=kwargs.get("protocol", "http"),
        protocols=kwargs.get("protocols"),
        port=kwargs.get("port"),
        host=kwargs.get("bind_host"),
        name=kwargs.get("name", kind),
    )

    async def _serve():
        # the signal handlers go in before readiness, so a terminate()
        # that races the start still stops the child gracefully
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            loop.add_signal_handler(sig, stop.set)
        await runtime.server.setup_server()
        port_value.value = runtime.server.port
        ready_event.set()
        try:
            serve_task = asyncio.create_task(runtime.server.run_server())
            stop_task = asyncio.create_task(stop.wait())
            done, pending = await asyncio.wait([serve_task, stop_task],
                                               return_when=asyncio.FIRST_COMPLETED)
            for t in pending:
                t.cancel()
            await asyncio.gather(*pending, return_exceptions=True)
            if serve_task in done:
                serve_task.result()  # surface a server crash
        finally:
            await runtime.server.shutdown()
            await handler.close()

    try:
        asyncio.run(_serve())
    except (KeyboardInterrupt, SystemExit):
        pass


class Pod:
    def __init__(self, kind: str, **kwargs):
        from marie_tpu_torch.auth import APIKeyManager

        if kind != "worker":
            raise not_ported(f"the {kind!r} pod")
        for key in ("raft", "discovery_address", "port_monitoring"):
            if kwargs.get(key):
                raise not_ported(f"a worker pod with {key!r}")
        if kwargs.get("protocol", "http").lower() != "http" or len(
                kwargs.get("protocols") or ["http"]) != 1:
            # refused here rather than in the child, where it would look
            # like a start-up failure
            proto = kwargs.get("protocols") or kwargs.get("protocol")
            raise not_ported(f"a worker pod over {proto!r}")
        if APIKeyManager.enabled() and not kwargs.get("auth_keys"):
            kwargs["auth_keys"] = [
                {"name": info["name"], "api_key": key, "enabled": info["enabled"],
                 "roles": info["roles"]}
                for key, info in APIKeyManager._keys.items()]
        self.kind = kind
        self.kwargs = kwargs
        self.name = kwargs.get("name", kind)
        self.logger = MarieLogger(f"pod/{self.name}")
        ctx = multiprocessing.get_context("spawn")
        self._ready = ctx.Event()
        self._port = ctx.Value("i", kwargs.get("port") or 0)
        self._process = ctx.Process(target=_pod_main,
                                    args=(kind, kwargs, self._ready, self._port),
                                    daemon=True, name=f"marie-pod-{self.name}")

    def start(self, timeout: float = READY_TIMEOUT_S) -> "Pod":
        self._process.start()
        deadline = time.time() + timeout
        while not self._ready.wait(0.2):
            if not self._process.is_alive():
                raise RuntimeFailToStart(
                    f"pod {self.name} died during startup (exitcode="
                    f"{self._process.exitcode}); check that the executor module is "
                    f"importable in subprocesses")
            if time.time() > deadline:
                self.close()
                raise RuntimeFailToStart(
                    f"pod {self.name} did not become ready within {timeout}s")
        return self

    @property
    def port(self) -> int:
        return self._port.value

    @property
    def address(self) -> str:
        return f"127.0.0.1:{self.port}"

    @property
    def exitcode(self):
        return self._process.exitcode

    def is_alive(self) -> bool:
        return self._process.is_alive()

    def close(self, timeout: float = 10.0) -> None:
        """SIGTERM (a graceful stop), then SIGKILL after ``timeout``."""
        if self._process.is_alive():
            self._process.terminate()
            self._process.join(timeout)
            if self._process.is_alive():
                self._process.kill()
                self._process.join(5)

    def __enter__(self) -> "Pod":
        return self.start()

    def __exit__(self, *args) -> None:
        self.close()
