from marie_tpu_torch.storage.manager import PathHandler, StorageManager
from marie_tpu_torch.storage.native_handler import NativePathHandler

__all__ = ["StorageManager", "PathHandler", "NativePathHandler"]
