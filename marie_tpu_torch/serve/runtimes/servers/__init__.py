from marie_tpu_torch.serve.runtimes.servers.grpc_server import GRPCServer
from marie_tpu_torch.serve.runtimes.servers.http_server import HTTPServer
from marie_tpu_torch.serve.runtimes.servers.websocket_server import WebSocketServer
from marie_tpu_torch.serve.runtimes.servers.composite import CompositeServer
from marie_tpu_torch.serve.runtimes.servers.cloud_http import (
    AzureHTTPServer, SagemakerHTTPServer)

__all__ = ["GRPCServer", "HTTPServer", "WebSocketServer", "CompositeServer",
           "SagemakerHTTPServer", "AzureHTTPServer"]
