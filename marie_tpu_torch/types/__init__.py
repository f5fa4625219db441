from marie_tpu_torch.types.docs import Document, DocumentArray

__all__ = ["Document", "DocumentArray"]
