"""The port's executors: the OCR, NER, classification, overlay and
template-matching endpoints a worker serves."""

from marie_tpu_torch.executor.classifier_executor import DocumentClassificationExecutor
from marie_tpu_torch.executor.ner_executor import NerExtractionExecutor
from marie_tpu_torch.executor.overlay_executor import OverlayExecutor
from marie_tpu_torch.executor.template_matching_executor import TemplateMatchingExecutor
from marie_tpu_torch.executor.text_extraction_executor import (
    TextExtractionExecutor,
    TextExtractionExecutorMock,
)

__all__ = [
    "TextExtractionExecutor",
    "TextExtractionExecutorMock",
    "DocumentClassificationExecutor",
    "NerExtractionExecutor",
    "OverlayExecutor",
    "TemplateMatchingExecutor",
]
