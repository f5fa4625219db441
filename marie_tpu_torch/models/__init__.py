"""The port's models (counterparts of ``marie_tpu/models/``): torch
modules whose parameters carry the flax trees' names and layouts
(``registry/convert.py``)."""

from marie_tpu_torch.models import configs

__all__ = ["configs"]
