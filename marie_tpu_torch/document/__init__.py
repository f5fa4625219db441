from marie_tpu_torch.document.ocr_processor import OcrProcessor
from marie_tpu_torch.document.trocr_ocr_processor import TrOcrProcessor
from marie_tpu_torch.document.crnn_ocr_processor import CrnnOcrProcessor
from marie_tpu_torch.document.tesseract_ocr_processor import TesseractOcrProcessor
from marie_tpu_torch.document.cloud_ocr_processors import (
    AwsTextractOcrProcessor,
    AzureVisionOcrProcessor,
    GoogleVisionOcrProcessor,
)

__all__ = [
    "OcrProcessor",
    "TrOcrProcessor",
    "CrnnOcrProcessor",
    "TesseractOcrProcessor",
    "GoogleVisionOcrProcessor",
    "AzureVisionOcrProcessor",
    "AwsTextractOcrProcessor",
]
