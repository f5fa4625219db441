"""The weight bridge (:mod:`.convert`), the ``.npz`` trees
(:mod:`.checkpoints`), the port's zoo (:mod:`.zoo`) and
:class:`ModelRegistry` (:mod:`.model_registry`)."""

from marie_tpu_torch.registry.model_registry import ModelRegistry

__all__ = ["ModelRegistry"]
