from marie_tpu_torch.serve.runtimes.servers.grpc_server import GRPCServer
from marie_tpu_torch.serve.runtimes.servers.http_server import HTTPServer

__all__ = ["GRPCServer", "HTTPServer"]
