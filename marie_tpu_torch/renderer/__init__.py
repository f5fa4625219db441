from marie_tpu_torch.renderer.renderer import ResultRenderer
from marie_tpu_torch.renderer.text_renderer import TextRenderer
from marie_tpu_torch.renderer.pdf_renderer import PdfRenderer
from marie_tpu_torch.renderer.adlib_renderer import AdlibRenderer
from marie_tpu_torch.renderer.blob_renderer import BlobRenderer

__all__ = [
    "ResultRenderer",
    "TextRenderer",
    "PdfRenderer",
    "AdlibRenderer",
    "BlobRenderer",
]
