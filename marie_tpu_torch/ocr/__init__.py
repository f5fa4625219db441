from marie_tpu_torch.enums import CoordinateFormat, PSMode
from marie_tpu_torch.ocr.ocr_engine import OcrEngine
from marie_tpu_torch.ocr.default_ocr_engine import DefaultOcrEngine
from marie_tpu_torch.ocr.mock_ocr_engine import MockOcrEngine
from marie_tpu_torch.ocr.voting_ocr_engine import VotingOcrEngine
from marie_tpu_torch.ocr.util import get_known_ocr_engines

__all__ = [
    "OcrEngine",
    "DefaultOcrEngine",
    "MockOcrEngine",
    "VotingOcrEngine",
    "CoordinateFormat",
    "PSMode",
    "get_known_ocr_engines",
]
