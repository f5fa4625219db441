from marie_tpu_torch.storage.kv.in_memory import InMemoryKV
from marie_tpu_torch.storage.kv.sqlite_kv import SqliteKV
from marie_tpu_torch.storage.kv.storage_client import StorageArea

__all__ = ["InMemoryKV", "SqliteKV", "StorageArea"]
