from marie_tpu_torch.storage.kv.sqlite_kv import SqliteKV
from marie_tpu_torch.storage.kv.storage_client import StorageArea

__all__ = ["SqliteKV", "StorageArea"]
