"""Embeddings base (port of ``marie_tpu/embeddings/base.py`` as a plain
abstract class, without the JAX package's YAML-configurable base):
pluggable text and document embedding providers."""

from abc import ABC, abstractmethod
from typing import Sequence

import numpy as np

from marie_tpu_torch.logging_core import MarieLogger


class EmbeddingsBase(ABC):
    def __init__(self, **kwargs):
        self.logger = MarieLogger(type(self).__name__)

    @abstractmethod
    def get_embeddings(self, texts: Sequence[str], **kwargs) -> np.ndarray:
        """[N texts] -> [N, D] float32 embeddings."""

    def embed_query(self, text: str) -> np.ndarray:
        return self.get_embeddings([text])[0]
