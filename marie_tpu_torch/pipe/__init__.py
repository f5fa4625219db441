from marie_tpu_torch.pipe.base_pipeline import BasePipeline
from marie_tpu_torch.pipe.classification_pipeline import ClassificationPipeline

__all__ = ["BasePipeline", "ClassificationPipeline"]
