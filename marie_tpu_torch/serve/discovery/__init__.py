"""Service discovery (port of ``marie_tpu/serve/discovery/``): the built-in
lease registry and an etcd v3 client with the same surface."""
from marie_tpu_torch.serve.discovery.etcd_client import EtcdClient
from marie_tpu_torch.serve.discovery.registry import DiscoveryClient, DiscoveryServer

__all__ = ["DiscoveryServer", "DiscoveryClient", "EtcdClient"]
