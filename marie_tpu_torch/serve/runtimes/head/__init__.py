from marie_tpu_torch.serve.runtimes.head.request_handling import HeaderRequestHandler

__all__ = ["HeaderRequestHandler"]
