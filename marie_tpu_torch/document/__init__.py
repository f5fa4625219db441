from marie_tpu_torch.document.ocr_processor import OcrProcessor
from marie_tpu_torch.document.trocr_ocr_processor import TrOcrProcessor
from marie_tpu_torch.document.crnn_ocr_processor import CrnnOcrProcessor

# TesseractOcrProcessor and the three cloud processors (Google, Azure,
# AWS) come with their modules: ROADMAP §1 item 13
__all__ = [
    "OcrProcessor",
    "TrOcrProcessor",
    "CrnnOcrProcessor",
]
