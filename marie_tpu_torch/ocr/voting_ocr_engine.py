"""VotingOcrEngine — ensemble recognition with word-level voting (port of
``marie_tpu/ocr/voting_ocr_engine.py``).  Detection comes from the box
processor; every recogniser reads the same words, so their outputs align
one to one, and each word takes the text most recognisers read, ties
going to the highest confidence; its confidence is the mean of the
winners'.

SPARSE and LINE pages run on the device: one detection per page
(:meth:`PipelineOcrEngine._detect_pages`) feeds every recogniser's
``recognize_dispatch`` with the same device page, then each recogniser
collects all pages with one copy.  The recognisers run under the
``"best"`` launch path.  The other modes (and recognisers without a
device dispatch) recognise host fragments page by page.
"""

from collections import Counter
from typing import Any, Dict, List, Sequence

import numpy as np

from marie_tpu_torch.document.ocr_processor import OcrProcessor, assemble_page_result
from marie_tpu_torch.enums import PSMode
from marie_tpu_torch.ocr.ocr_engine import PipelineOcrEngine, finish_result
from marie_tpu_torch.ops.kernels._build import launch_path


class VotingOcrEngine(PipelineOcrEngine):
    """A box processor and several OCR processors whose words are voted
    (the JAX package's ``VotingOcrEngine``; the registry's ``best`` is
    CRAFT over TrOCR beam-5 and the CRNN)."""

    def __init__(self, box_processor, ocr_processors: Sequence[OcrProcessor], **kwargs):
        if len(ocr_processors) == 0:
            raise ValueError("VotingOcrEngine needs at least one ocr_processor")
        super().__init__(box_processor, ocr_processors[0], **kwargs)
        self.ocr_processors = list(ocr_processors)

    @property
    def trained(self) -> Dict[str, Any]:
        """The zoo tree of the detector and of each recogniser, in order
        (None: seeded weights)."""
        return {"detector": getattr(self.box_processor, "zoo_name", None),
                "recognizers": [getattr(p, "zoo_name", None) for p in self.ocr_processors]}

    def _extract_fullpage(self, frames, pms_mode, coordinate_format, queue_id, **kwargs):
        procs = [p for p in self.ocr_processors if p.is_available()]
        if not procs:
            raise RuntimeError(
                "VotingOcrEngine: no ocr_processor is available "
                f"({[type(p).__name__ for p in self.ocr_processors]})")
        device_ready = (
            pms_mode in (PSMode.SPARSE, PSMode.LINE)
            and hasattr(self.box_processor, "detect_dispatch")
            and all(hasattr(p, "recognize_dispatch") for p in procs)
        )
        if device_ready and self.single_program:
            return self._extract_fullpage_device(frames, procs, pms_mode, coordinate_format)
        results = []
        checksum = kwargs.get("checksum", "")
        for i, frame in enumerate(frames):
            boxes, fragments, lines, _, line_bboxes = (
                self.box_processor.extract_bounding_boxes(queue_id, checksum, frame, pms_mode))
            with launch_path("best"):
                candidates = [proc.recognize_from_fragments(fragments) for proc in procs]
            voted = [self._vote([c[j] for c in candidates]) for j in range(len(fragments))]
            # the page result through the base aligner, fed the voted words
            result, _ = _RecognizeWith(voted).recognize(
                queue_id, checksum, frame, boxes, fragments, lines)
            results.append(finish_result(result, i, lines, line_bboxes, coordinate_format))
        return results

    def _extract_fullpage_device(self, frames, procs, pms_mode, coordinate_format):
        """One upload and one detection per page feed every recogniser;
        candidate words align one to one by box, so the vote equals the
        host-fragment path's."""
        pages = self._detect_pages(frames, pms_mode)
        with launch_path("best"):
            futures = [[proc.recognize_dispatch(handle[1], page[0], handle[2])
                        for handle, page in pages] for proc in procs]
            collected = [proc.recognize_collect_many(fl) for proc, fl in zip(procs, futures)]
        results = []
        for i, (frame, (_, (boxes, _scores, lines, line_bboxes))) in enumerate(
                zip(frames, pages)):
            voted = [self._vote([c[i][j] for c in collected]) for j in range(len(boxes))]
            result = assemble_page_result((frame.shape[0], frame.shape[1]), boxes, lines, voted)
            results.append(finish_result(result, i, lines, line_bboxes, coordinate_format))
        return results

    @staticmethod
    def _vote(candidates: List[Dict[str, Any]]) -> Dict[str, Any]:
        """Majority text vote; ties broken by max confidence."""
        if not candidates:
            return {"text": "", "confidence": 0.0}
        texts = [c["text"] for c in candidates]
        counts = Counter(texts)
        top_count = counts.most_common(1)[0][1]
        tied = [t for t, n in counts.items() if n == top_count]
        best_text = max(
            tied, key=lambda t: max(c["confidence"] for c in candidates if c["text"] == t))
        confs = [c["confidence"] for c in candidates if c["text"] == best_text]
        return {"text": best_text, "confidence": float(np.mean(confs))}


class _RecognizeWith(OcrProcessor):
    """Adapter feeding pre-computed word results through the base aligner."""

    def __init__(self, results: List[Dict[str, Any]]):
        self._results = results

    def recognize_from_fragments(self, fragments):
        return self._results
