"""Engine registry (port of ``marie_tpu/ocr/util.py``): the known engines
built over the port's zoo (``torch_zoo/``, :mod:`marie_tpu_torch.registry.zoo`),
and :func:`meta_to_text`.

The JAX registry walks ladders of checkpoints; ``torch_zoo/`` holds one
detector, one TrOCR and one CRNN, so the ladders are cut to those.  As in the
JAX package, a missing tree falls back to seeded weights (and the
detector to ink boxes); :attr:`PipelineOcrEngine.trained` says which
trees an engine loaded.
"""

import os
from typing import Dict, Optional

from marie_tpu_torch.registry.zoo import zoo_params

#: the zoo trees of the serving detector and recogniser
DETECTOR_TREE = "craft-s2d2-synth"
RECOGNIZER_TREE = "trocr-fast3g2d6ov-synth"
#: the zoo tree of the CTC recogniser the ``best`` engine votes with
CRNN_TREE = "crnn-synth"


def craft_box_processor(max_components: int = 384, *, device="cuda", **kwargs):
    """The trained heatmap detector (bfloat16, ``text_threshold`` 0.6,
    ``low_text`` 0.4) when the zoo holds it; ink boxes over seeded weights
    otherwise.  ``kwargs`` go to :class:`BoxProcessorCraft` (``cc_runs``,
    ``bucket_spec``, ...)."""
    from marie_tpu_torch.boxes.craft_box_processor import BoxProcessorCraft
    from marie_tpu_torch.models.configs import CraftConfig

    variables = zoo_params(DETECTOR_TREE)
    if variables is None:
        return BoxProcessorCraft(box_source="ink", min_area=4, max_components=max_components,
                                 device=device, **kwargs)
    bp = BoxProcessorCraft(
        config=CraftConfig.fast_s2d2(), variables=variables, box_source="heatmap",
        text_threshold=0.6, low_text=0.4, link_threshold=0.4,
        max_components=max_components, param_dtype="bfloat16", device=device, **kwargs)
    bp.zoo_name = DETECTOR_TREE
    return bp


def trocr_processor(beam_size: int = 1, *, device="cuda", **kwargs):
    """The trained TrOCR (bfloat16; greedy, or beam search with
    ``beam_size > 1``) when the zoo holds it, seeded weights otherwise.
    ``kwargs`` go to :class:`TrOcrProcessor`."""
    from marie_tpu_torch.document.trocr_ocr_processor import TrOcrProcessor
    from marie_tpu_torch.models.configs import TrOCRConfig

    params = zoo_params(RECOGNIZER_TREE)
    op = TrOcrProcessor(config=TrOCRConfig.fast_v3_g2_d6(), params=params,
                        beam_size=beam_size, param_dtype="bfloat16", device=device, **kwargs)
    op.zoo_name = None if params is None else RECOGNIZER_TREE
    return op


def crnn_processor(*, device="cuda", **kwargs):
    """The trained CRNN/CTC recogniser (float32) when the zoo holds it,
    seeded weights otherwise.  ``kwargs`` go to :class:`CrnnOcrProcessor`."""
    from marie_tpu_torch.document.crnn_ocr_processor import CrnnOcrProcessor

    variables = zoo_params(CRNN_TREE)
    op = CrnnOcrProcessor(variables=variables, device=device, **kwargs)
    op.zoo_name = None if variables is None else CRNN_TREE
    return op


def _upload_format() -> str:
    """Page upload packing for the serving engines: ``MARIE_UPLOAD_FORMAT``,
    default u4 (4-bit grayscale)."""
    return os.environ.get("MARIE_UPLOAD_FORMAT", "u4")


def get_known_ocr_engines(device="cuda", engine: Optional[str] = None) -> Dict[str, object]:
    """Build the known engines; ``engine`` builds one by name.

    * ``mock``    — canned results, no models
    * ``default`` — CRAFT + greedy TrOCR from the zoo
    * ``chained`` — default + the LayoutLM classification and NER heads
      in each page group's program (behaves as ``default`` when the zoo
      lacks either head)
    * ``best``    — CRAFT detection and a word-level vote of TrOCR beam-5
      and the CRNN (:class:`VotingOcrEngine`)
    """
    from marie_tpu_torch.ocr.mock_ocr_engine import MockOcrEngine
    from marie_tpu_torch.ocr.ocr_engine import PipelineOcrEngine

    engines: Dict[str, object] = {}
    for name in [engine] if engine else ["mock", "default", "best", "chained"]:
        if name == "mock":
            engines[name] = MockOcrEngine()
        elif name == "default":
            engines[name] = PipelineOcrEngine(
                craft_box_processor(device=device), trocr_processor(device=device),
                upload_format=_upload_format())
        elif name == "chained":
            from marie_tpu_torch.components.document_classifier import (
                LayoutDocumentClassifier,
            )
            from marie_tpu_torch.components.document_indexer import LayoutDocumentIndexer

            engines[name] = PipelineOcrEngine(
                craft_box_processor(device=device), trocr_processor(device=device),
                classifier=LayoutDocumentClassifier.from_zoo_chain(device=device),
                indexer=LayoutDocumentIndexer.from_zoo_chain(device=device),
                upload_format=_upload_format())
        elif name == "best":
            from marie_tpu_torch.ocr.voting_ocr_engine import VotingOcrEngine

            engines[name] = VotingOcrEngine(
                craft_box_processor(device=device),
                [trocr_processor(beam_size=5, device=device), crnn_processor(device=device)])
        else:
            raise ValueError(f"unknown engine {name!r}")
    return engines


def meta_to_text(meta_or_path, text_output_path: Optional[str] = None) -> str:
    """OCR results (a list of page dicts, one dict, or the path of their
    JSON) -> plain text: each page's line texts in line order, pages
    joined by a form feed, as the JAX package's ``TextRenderer`` writes
    them.  With ``text_output_path`` the text is written there too."""
    import json

    if isinstance(meta_or_path, (str, os.PathLike)):
        with open(meta_or_path) as f:
            results = json.load(f)
    else:
        results = meta_or_path
    if isinstance(results, dict):
        results = [results]
    pages = []
    for result in results:
        if not result.get("words"):
            pages.append("")
            continue
        lines = sorted(result.get("lines", []), key=lambda ln: ln["line"])
        pages.append("\n".join(ln["text"] for ln in lines))
    text = "\n\f\n".join(pages)
    if text_output_path is not None:
        with open(text_output_path, "w") as f:
            f.write(text)
    return text

