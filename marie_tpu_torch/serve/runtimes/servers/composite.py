"""CompositeServer (port of ``marie_tpu/serve/runtimes/servers/composite.py``):
several protocol servers, each on its own port, over one request handler."""

import asyncio
from typing import List, Optional, Sequence


class CompositeServer:
    def __init__(self, req_handler, protocols: Sequence[str] = ("grpc", "http"),
                 ports: Optional[Sequence[Optional[int]]] = None, host: Optional[str] = None,
                 name: str = "composite", **kwargs):
        from marie_tpu_torch.serve.runtimes.servers.grpc_server import GRPCServer
        from marie_tpu_torch.serve.runtimes.servers.http_server import HTTPServer
        from marie_tpu_torch.serve.runtimes.servers.websocket_server import WebSocketServer

        ports = list(ports or [None] * len(protocols))
        self.servers: List = []
        for proto, port in zip(protocols, ports):
            cls = {"grpc": GRPCServer, "http": HTTPServer,
                   "websocket": WebSocketServer}[proto.lower()]
            # kwargs reach every server (the HTTP server's ``cors``)
            self.servers.append(cls(req_handler, port=port, host=host, name=f"{name}/{proto}",
                                    **kwargs))
        self.req_handler = req_handler

    async def setup_server(self) -> None:
        for s in self.servers:
            await s.setup_server()

    async def run_server(self) -> None:
        await asyncio.gather(*(s.run_server() for s in self.servers))

    async def shutdown(self) -> None:
        for s in self.servers:
            await s.shutdown()

    @property
    def port(self) -> int:
        """The first server's port (the one a pod registers)."""
        return self.servers[0].port

    @property
    def addresses(self) -> List[str]:
        return [getattr(s, "address", "") for s in self.servers]
