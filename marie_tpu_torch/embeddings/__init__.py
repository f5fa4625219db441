from marie_tpu_torch.embeddings.base import EmbeddingsBase
from marie_tpu_torch.embeddings.hashing import HashingEmbeddings
from marie_tpu_torch.embeddings.layout_embeddings import LayoutEmbeddingsModel

__all__ = ["EmbeddingsBase", "HashingEmbeddings", "LayoutEmbeddingsModel"]
