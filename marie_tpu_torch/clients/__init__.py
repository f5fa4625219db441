"""Clients of the port's serving plane: HTTP only (gRPC and WebSocket
wait for the gRPC slice)."""

from typing import Optional

from marie_tpu_torch.clients.http_client import HTTPClient
from marie_tpu_torch.excepts import not_ported


def Client(host: str = "127.0.0.1", port: Optional[int] = None, protocol: str = "http",
           **kwargs):
    """The client for ``protocol``."""
    protocol = protocol.lower()
    if protocol == "http":
        return HTTPClient(host=host, port=port, **kwargs)
    if protocol in ("grpc", "websocket"):
        raise not_ported(f"the {protocol} client")
    raise ValueError(f"unknown protocol {protocol!r}")


__all__ = ["Client", "HTTPClient"]
