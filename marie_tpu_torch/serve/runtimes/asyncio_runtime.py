"""AsyncNewLoopRuntime (port of ``marie_tpu/serve/runtimes/asyncio_runtime.py``):
one asyncio loop per serving process, serving a request handler until
SIGINT/SIGTERM or :meth:`cancel`, then tearing down.

Protocols: ``"grpc"`` (the default, :class:`GRPCServer`), ``"http"``
(:class:`HTTPServer`), ``"websocket"`` (:class:`WebSocketServer`),
``"sagemaker"`` and ``"azure"`` (the cloud HTTP apps); ``protocols`` of
more than one gives a :class:`CompositeServer` on ``ports``.  A
``port_monitoring`` serves ``/metrics`` on a port of its own (the
registry's metrics and the kernels' launches, as the HTTP server's
``/metrics``).  ``cors`` goes to the HTTP servers (the JAX runtime leaves
it to the HTTP server's own argument).
"""

import asyncio
import signal
import threading
from typing import Optional

from marie_tpu_torch.logging_core import MarieLogger


class AsyncNewLoopRuntime:
    def __init__(self, req_handler, protocol: str = "grpc", port: Optional[int] = None,
                 host: Optional[str] = None, name: str = "runtime", protocols=None,
                 ports=None, port_monitoring: Optional[int] = None, cors: bool = False):
        self.logger = MarieLogger(f"runtime/{name}")
        self.req_handler = req_handler
        self.name = name
        self._cancel_event: Optional[asyncio.Event] = None
        self.port_monitoring = port_monitoring
        self._monitoring_server = None
        self.server = self._build_server(protocol, port, host, name, protocols, ports, cors)

    def _build_server(self, protocol, port, host, name, protocols, ports, cors=False):
        from marie_tpu_torch.serve.runtimes.servers import (
            AzureHTTPServer, CompositeServer, GRPCServer, HTTPServer, SagemakerHTTPServer,
            WebSocketServer)

        extra = {"cors": True} if cors else {}
        if protocols and len(protocols) > 1:
            return CompositeServer(self.req_handler, protocols=protocols, ports=ports,
                                   host=host, name=name, **extra)
        proto = (protocols[0] if protocols else protocol).lower()
        cls = {"grpc": GRPCServer, "http": HTTPServer, "websocket": WebSocketServer,
               "sagemaker": SagemakerHTTPServer, "azure": AzureHTTPServer}.get(proto)
        if cls is None:
            raise ValueError(f"unknown protocol {proto!r}")
        return cls(self.req_handler, port=port, host=host, name=name, **extra)

    async def _start_monitoring(self) -> None:
        """``/metrics`` on ``port_monitoring``, for any protocol."""
        from marie_tpu_torch.helper import default_bind_host
        from marie_tpu_torch.serve.runtimes.servers.http_server import HTTPServer

        server = HTTPServer(None, port=self.port_monitoring, host=default_bind_host(),
                            name=f"{self.name}/monitoring", routes=[])
        server.add_route("GET", "/metrics", server._metrics)
        await server.setup_server()
        self._monitoring_server = server
        self.logger.debug(f"metrics on :{self.port_monitoring}/metrics")

    async def _stop_monitoring(self) -> None:
        if self._monitoring_server is not None:
            await self._monitoring_server.shutdown()
            self._monitoring_server = None

    async def _serve(self) -> None:
        self._cancel_event = asyncio.Event()
        await self.server.setup_server()
        if self.port_monitoring:
            await self._start_monitoring()
        loop = asyncio.get_running_loop()
        if threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGINT, signal.SIGTERM):
                try:
                    loop.add_signal_handler(sig, self._cancel_event.set)
                except (NotImplementedError, RuntimeError):
                    pass
        run_task = asyncio.create_task(self.server.run_server())
        cancel_task = asyncio.create_task(self._cancel_event.wait())
        try:
            await asyncio.wait([run_task, cancel_task], return_when=asyncio.FIRST_COMPLETED)
        finally:
            run_task.cancel()
            cancel_task.cancel()
            await self.server.shutdown()
            await self._stop_monitoring()
            if hasattr(self.req_handler, "close"):
                await self.req_handler.close()

    def run_forever(self) -> None:
        asyncio.run(self._serve())

    def cancel(self) -> None:
        if self._cancel_event is not None:
            self._cancel_event.set()
