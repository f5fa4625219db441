"""KV store interface (copy of ``marie_tpu/storage/kv/storage_client.py``)."""

from abc import ABC, abstractmethod
from typing import Dict, List, Optional


class StorageArea(ABC):
    @abstractmethod
    async def internal_kv_get(self, key: bytes, namespace: Optional[bytes]) -> Optional[bytes]: ...

    @abstractmethod
    async def internal_kv_put(
        self, key: bytes, value: bytes, overwrite: bool, namespace: Optional[bytes]
    ) -> int: ...

    @abstractmethod
    async def internal_kv_del(self, key: bytes, namespace: Optional[bytes]) -> int: ...

    @abstractmethod
    async def internal_kv_exists(self, key: bytes, namespace: Optional[bytes]) -> bool: ...

    @abstractmethod
    async def internal_kv_keys(
        self, prefix: bytes, namespace: Optional[bytes]
    ) -> List[bytes]: ...

    async def debug_dump(self) -> Dict[str, Dict[str, bytes]]:
        return {}
