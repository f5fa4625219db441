from marie_tpu_torch.pipe.base_pipeline import BasePipeline
from marie_tpu_torch.pipe.classification_pipeline import ClassificationPipeline
from marie_tpu_torch.pipe.extract_pipeline import ExtractPipeline

__all__ = ["BasePipeline", "ClassificationPipeline", "ExtractPipeline"]
