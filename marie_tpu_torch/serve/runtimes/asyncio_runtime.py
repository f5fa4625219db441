"""AsyncNewLoopRuntime (port of ``marie_tpu/serve/runtimes/asyncio_runtime.py``):
one asyncio loop per serving process, serving a request handler until
SIGINT/SIGTERM or :meth:`cancel`, then tearing down.

Only ``"http"`` is ported (:class:`HTTPServer`, which also serves
``/metrics``).  gRPC, WebSocket, several protocols at once, the cloud HTTP
variants and a separate monitoring port wait for the gRPC slice.
"""

import asyncio
import signal
import threading
from typing import Optional

from marie_tpu_torch.excepts import not_ported
from marie_tpu_torch.logging_core import MarieLogger


class AsyncNewLoopRuntime:
    def __init__(self, req_handler, protocol: str = "http", port: Optional[int] = None,
                 host: Optional[str] = None, name: str = "runtime", protocols=None,
                 ports=None, port_monitoring: Optional[int] = None):
        self.logger = MarieLogger(f"runtime/{name}")
        self.req_handler = req_handler
        self.name = name
        self._cancel_event: Optional[asyncio.Event] = None
        if port_monitoring:
            raise not_ported("a separate monitoring port (HTTP serves /metrics)")
        self.port_monitoring = None
        self.server = self._build_server(protocol, port, host, name, protocols)

    def _build_server(self, protocol, port, host, name, protocols):
        from marie_tpu_torch.serve.runtimes.servers import HTTPServer

        if protocols and len(protocols) > 1:
            raise not_ported(f"serving several protocols at once ({list(protocols)})")
        proto = (protocols[0] if protocols else protocol).lower()
        if proto in ("grpc", "websocket", "sagemaker", "azure"):
            raise not_ported(f"the {proto!r} protocol")
        if proto != "http":
            raise ValueError(f"unknown protocol {proto!r}")
        return HTTPServer(self.req_handler, port=port, host=host, name=name)

    async def _serve(self) -> None:
        self._cancel_event = asyncio.Event()
        await self.server.setup_server()
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
            if hasattr(self.req_handler, "close"):
                await self.req_handler.close()

    def run_forever(self) -> None:
        asyncio.run(self._serve())

    def cancel(self) -> None:
        if self._cancel_event is not None:
            self._cancel_event.set()
