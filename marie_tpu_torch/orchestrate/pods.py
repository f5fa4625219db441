"""Pod (port of ``marie_tpu/orchestrate/pods.py``): one serving process.

``Pod(kind, ..., protocol="grpc").start()`` spawns a child (the
``spawn`` context: the parent may hold a CUDA context, which a forked
child cannot use) that builds the kind's request handler and an
:class:`AsyncNewLoopRuntime`, binds its port and signals readiness; the
parent waits for that.  Kinds: ``"worker"`` (a
:class:`WorkerRequestHandler` of ``uses``), ``"head"`` (a
:class:`HeaderRequestHandler` over ``shard_addresses`` with ``polling``)
and ``"gateway"`` (a :class:`GatewayRequestHandler` over
``graph_representation`` and ``executor_addresses``).  The protocol is
``"grpc"`` by default, or any of the runtime's (``protocols`` for several
at once, on ``ports``); ``port_monitoring`` serves ``/metrics`` on a port of
its own.  With ``discovery_address`` the child registers
``gateway/<deployment>/<name>`` (``{"address": "127.0.0.1:<port>"}``)
under a lease of ``DEFAULT_LEASE_TTL`` kept alive every third of it, once
its server is bound and before it signals readiness, and deletes the key
on a graceful stop.  SIGTERM stops the child gracefully (the key deleted,
server shutdown, then the executor's ``close``).  The child inherits
``CUDA_VISIBLE_DEVICES`` and the rest of the environment; the executor's
device comes from ``uses_with``, and
``uses`` travels as a class (pickled by reference), a dotted path, a
``jtype`` mapping or YAML.  A worker runs its executor's programs once
before it signals readiness (:func:`marie_tpu_torch.utils.program_zoo.prewarm`;
on by default on the card, ``MARIE_PROGRAM_ZOO_ENABLE=0`` turns it off);
a warm-up that raises fails the start (:class:`RuntimeFailToStart`).
The CUDA kernels the child launches load from the libraries the parent
built (``ops/kernels/_build.py`` names them by a hash of their source).
``env`` sets variables in the child before it builds its handler.  A
worker with ``raft`` (``{"node_id", "bind_addr", "peers": [(id,
addr), ...]}``) serves through a
:class:`~marie_tpu_torch.serve.consensus.stateful.StatefulReplicatedHandler`:
its writes replicate through RAFT.  Its child sets ``MARIE_RAFT_NODE_ID``
to the node id before the executor loads, so that a config can give each
replica its own paths (``${{ ENV.MARIE_RAFT_NODE_ID }}``): every replica
applies the same requests.
"""

import multiprocessing
import time
from typing import Any, Dict

from marie_tpu_torch.excepts import RuntimeFailToStart
from marie_tpu_torch.logging_core import MarieLogger

#: how long :meth:`Pod.start` waits for the child's readiness by default
#: (a worker loads its models and warms them first)
READY_TIMEOUT_S = 120.0


def _pod_main(kind: str, kwargs: Dict[str, Any], ready_event, port_value) -> None:
    """The child's entry point: serve until SIGTERM/SIGINT."""
    import asyncio
    import os
    import signal

    from marie_tpu_torch.serve.runtimes.asyncio_runtime import AsyncNewLoopRuntime

    os.environ.update(kwargs.get("env") or {})
    if kwargs.get("raft"):
        os.environ["MARIE_RAFT_NODE_ID"] = kwargs["raft"]["node_id"]

    if kwargs.get("auth_keys"):
        # a spawned child starts with no keys: load the parent's
        from marie_tpu_torch.auth import APIKeyManager

        APIKeyManager.from_config(kwargs["auth_keys"])

    if kind == "worker":
        from marie_tpu_torch.serve.runtimes.worker.request_handling import (
            WorkerRequestHandler)

        handler = WorkerRequestHandler(
            uses=kwargs.get("uses"),
            uses_with=kwargs.get("uses_with"),
            name=kwargs.get("name", "executor"),
            workspace=kwargs.get("workspace"),
            job_kv_path=kwargs.get("job_kv_path"),
        )
        from marie_tpu_torch.utils.program_zoo import prewarm, warmup_enabled

        if warmup_enabled():
            # the executor's programs run once before readiness; a failure
            # here ends the child, and the parent's start raises
            prewarm(handler.executor)
        if kwargs.get("raft"):
            # a stateful replica: writes replicate through RAFT, and the
            # node joins its peers once the executor is warm
            from marie_tpu_torch.serve.consensus.stateful import StatefulReplicatedHandler

            raft = kwargs["raft"]
            handler = StatefulReplicatedHandler(handler, node_id=raft["node_id"],
                                                bind_addr=raft["bind_addr"],
                                                peers=raft.get("peers", []))
    elif kind == "gateway":
        from marie_tpu_torch.serve.runtimes.gateway.request_handling import (
            GatewayRequestHandler)

        handler = GatewayRequestHandler(
            graph_representation=kwargs["graph_representation"],
            executor_addresses=kwargs["executor_addresses"],
            prefetch=kwargs.get("prefetch", 0),
            floating_deployments=kwargs.get("floating_deployments"),
            node_conditions=kwargs.get("node_conditions"),
            name=kwargs.get("name", "gateway"),
        )
    else:
        from marie_tpu_torch.enums import PollingType
        from marie_tpu_torch.serve.runtimes.head.request_handling import HeaderRequestHandler

        raw_polling = kwargs.get("polling", "all")
        handler = HeaderRequestHandler(
            shard_addresses=kwargs["shard_addresses"],
            polling=raw_polling if isinstance(raw_polling, dict)
            else PollingType(str(raw_polling).lower()),
            name=kwargs.get("name", "head"),
        )
    runtime = AsyncNewLoopRuntime(
        handler,
        protocol=kwargs.get("protocol", "grpc"),
        protocols=kwargs.get("protocols"),
        ports=kwargs.get("ports"),
        port=kwargs.get("port"),
        host=kwargs.get("bind_host"),
        name=kwargs.get("name", kind),
        port_monitoring=kwargs.get("port_monitoring"),
    )

    async def _serve():
        # the signal handlers go in before readiness, so a terminate()
        # that races the start still stops the child gracefully
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            loop.add_signal_handler(sig, stop.set)
        await runtime.server.setup_server()
        if runtime.port_monitoring:
            await runtime._start_monitoring()
        port_value.value = runtime.server.port
        discovery = discovery_key = None
        if kwargs.get("discovery_address"):
            import json

            from marie_tpu_torch.serve.discovery import DiscoveryClient

            discovery = DiscoveryClient(kwargs["discovery_address"])
            deployment = kwargs.get("deployment", kwargs.get("name", kind))
            discovery_key = f"gateway/{deployment}/{kwargs.get('name', kind)}"
            await discovery.register(
                discovery_key, json.dumps({"address": f"127.0.0.1:{port_value.value}"}))
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
            if discovery is not None:
                # a graceful stop deregisters at once, so that a gateway
                # reroutes now rather than at the lease's expiry
                try:
                    await discovery.delete(discovery_key)
                except Exception:  # noqa: BLE001 — the registry may be gone
                    pass
                await discovery.close()
            await runtime.server.shutdown()
            await runtime._stop_monitoring()
            await handler.close()

    try:
        asyncio.run(_serve())
    except (KeyboardInterrupt, SystemExit):
        pass


class Pod:
    def __init__(self, kind: str, **kwargs):
        from marie_tpu_torch.auth import APIKeyManager

        if kind not in ("worker", "head", "gateway"):
            raise ValueError(f"unknown pod kind {kind}")
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

    def launch(self) -> "Pod":
        """Start the child without waiting for it (see :meth:`wait_ready`)."""
        self._process.start()
        return self

    def wait_ready(self, timeout: float = READY_TIMEOUT_S) -> "Pod":
        """Wait until the child serves; it is closed when it does not
        within ``timeout``."""
        deadline = time.time() + timeout
        while not self._ready.wait(0.2):
            if not self._process.is_alive():
                raise RuntimeFailToStart(
                    f"pod {self.name} died during startup (exitcode="
                    f"{self._process.exitcode}); check that the executor module is "
                    f"importable in subprocesses and that it loads and warms up")
            if time.time() > deadline:
                self.close()
                raise RuntimeFailToStart(
                    f"pod {self.name} did not become ready within {timeout}s")
        return self

    def start(self, timeout: float = READY_TIMEOUT_S) -> "Pod":
        return self.launch().wait_ready(timeout)

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

    def terminate(self) -> None:
        """SIGTERM (a graceful stop), without waiting."""
        if self._process.is_alive():
            self._process.terminate()

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
