from marie_tpu_torch.serve.networking.connection_pool import GrpcConnectionPool

__all__ = ["GrpcConnectionPool"]
