"""Clients of the port's serving plane: gRPC (the default, as in the JAX
package), HTTP and WebSocket."""

from typing import Optional

from marie_tpu_torch.clients.grpc_client import GRPCClient
from marie_tpu_torch.clients.http_client import HTTPClient
from marie_tpu_torch.clients.websocket_client import WebSocketClient


def Client(host: str = "127.0.0.1", port: Optional[int] = None, protocol: str = "grpc",
           **kwargs):
    """The client for ``protocol``."""
    protocol = protocol.lower()
    if protocol == "grpc":
        return GRPCClient(host=host, port=port, **kwargs)
    if protocol == "http":
        return HTTPClient(host=host, port=port, **kwargs)
    if protocol == "websocket":
        return WebSocketClient(host=host, port=port, **kwargs)
    raise ValueError(f"unknown protocol {protocol!r}")


__all__ = ["Client", "GRPCClient", "HTTPClient", "WebSocketClient"]
