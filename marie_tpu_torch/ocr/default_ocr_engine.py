"""DefaultOcrEngine — CRAFT detection + TrOCR recognition (port of
``marie_tpu/ocr/default_ocr_engine.py``; upstream marie pairs its default
detector with TrOCR).

Without processors given, it builds them as the registry's ``default``
engine does (:mod:`marie_tpu_torch.ocr.util`): the trained trees of the
port's zoo (``torch_zoo/``) where present, seeded weights otherwise.  The
JAX engine's ``models_dir`` is not taken: the port's trees live in its
zoo.  It runs on the card unless ``device="cpu"``.
"""

from marie_tpu_torch.ocr.ocr_engine import PipelineOcrEngine
from marie_tpu_torch.utils.device import resolve_device


class DefaultOcrEngine(PipelineOcrEngine):
    def __init__(
        self,
        box_processor=None,
        ocr_processor=None,
        beam_size: int = 1,
        device="cuda",
        **kwargs,
    ):
        from marie_tpu_torch.ocr.util import craft_box_processor, trocr_processor

        dev = resolve_device(device)
        box = box_processor or craft_box_processor(device=dev)
        icr = ocr_processor or trocr_processor(beam_size=beam_size, device=dev)
        super().__init__(box, icr, **kwargs)
