"""An in-memory KV (port of ``marie_tpu/storage/kv/in_memory.py``), for
tests and single-process deployments."""

from typing import Dict, Optional

from marie_tpu_torch.storage.kv.storage_client import StorageArea

_DEFAULT_NS = b"__default__"


class InMemoryKV(StorageArea):
    def __init__(self):
        self._store: Dict[bytes, Dict[bytes, bytes]] = {}

    def _ns(self, namespace: Optional[bytes]) -> Dict[bytes, bytes]:
        return self._store.setdefault(namespace or _DEFAULT_NS, {})

    async def internal_kv_get(self, key, namespace=None):
        return self._ns(namespace).get(key)

    async def internal_kv_put(self, key, value, overwrite=True, namespace=None):
        ns = self._ns(namespace)
        if key in ns and not overwrite:
            return 0
        ns[key] = value
        return 1

    async def internal_kv_del(self, key, namespace=None):
        return 1 if self._ns(namespace).pop(key, None) is not None else 0

    async def internal_kv_exists(self, key, namespace=None):
        return key in self._ns(namespace)

    async def internal_kv_keys(self, prefix, namespace=None):
        return [k for k in self._ns(namespace) if k.startswith(prefix)]

    async def debug_dump(self):
        return {ns.decode(): {k.decode(): v for k, v in d.items()}
                for ns, d in self._store.items()}
