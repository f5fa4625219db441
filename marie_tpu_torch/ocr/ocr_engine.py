"""PipelineOcrEngine — the port's OCR entry point (port of
``marie_tpu/ocr/ocr_engine.py``): a box processor (detection) and an OCR
processor (recognition) over full pages, returning one result dict per
page in the JAX package's schema (``words``, ``lines``, ``meta.lines``,
``meta.lines_bboxes``, ``meta.format``; boxes xywh or xyxy).

SPARSE and LINE pages take one of the JAX engine's three paths, by what
the processors offer: the fused path of :mod:`marie_tpu_torch.ocr.fused`
(``single_program=True``, streamed group by group); else, for a detector
with ``detect_with_page`` (the page stays on the device) and a recogniser
with ``recognize_dispatch``, the page-resident path (detect every page,
then recognise every page's boxes from its device page; a detector with
``detect_dispatch`` dispatches every page's detection first); else host
fragments, as the other modes.  Kernel launches of the page-resident
recognition count on the ``"two_phase"`` path.  With both a
``classifier`` and an ``indexer``, the fused path runs the LayoutLM heads
in each group's program (:mod:`marie_tpu_torch.ocr.fused_chain`) and
adds ``classification`` to each page and ``ner_label`` to its words.
WORD, RAW_LINE and MULTI_LINE pages are cut into host fragments
(``BoxProcessor.extract_bounding_boxes``) and recognised together
(``TrOcrProcessor.recognize_from_fragments``).  ``regions`` cuts each
region out of its page and extracts it in its own mode.

``mesh`` is taken as the JAX engine takes it: ``"local"`` is a local
mesh over every visible card where there are two or more, and no mesh on
the CPU or on one card; a :class:`~marie_tpu_torch.parallel.mesh.Mesh`
is taken as it is (:func:`~marie_tpu_torch.utils.device.resolve_mesh`).
The fused path splits each page group whose padded size divides by the
mesh's entry count over the entries, and runs any other group whole
(:func:`~marie_tpu_torch.ocr.fused.fused_dispatch_stream`).

:class:`OcrEngine` is the abstract base of every engine (the JAX
package's): ``extract`` over frames or regions.
"""

from abc import ABC, abstractmethod
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from marie_tpu_torch.boxes.box_processor import np_rgb
from marie_tpu_torch.document.ocr_processor import assemble_page_result
from marie_tpu_torch.enums import CoordinateFormat, PSMode
from marie_tpu_torch.logging_core import MarieLogger
from marie_tpu_torch.ocr.fused import (
    UPLOAD_FORMATS,
    fused_collect_many,
    fused_dispatch_stream,
    handle_page_count,
    supports_fused_page,
)
from marie_tpu_torch.ops.kernels._build import launch_path
from marie_tpu_torch.utils.device import resolve_mesh


class OcrEngine(ABC):
    """Extracts text from frames (full page) or regions."""

    def __init__(self, **kwargs):
        self.logger = MarieLogger(type(self).__name__)

    @abstractmethod
    def extract(
        self,
        frames,
        pms_mode: PSMode = PSMode.SPARSE,
        coordinate_format: CoordinateFormat = CoordinateFormat.XYWH,
        regions: Optional[List[Dict[str, Any]]] = None,
        queue_id: str = "",
        **kwargs,
    ) -> List[Dict[str, Any]]:
        """One result dict per page (``meta`` with ``page``, ``lines``,
        ``lines_bboxes`` and ``format``; ``words``; ``lines``), or one per
        region with ``regions``."""


class PipelineOcrEngine(OcrEngine):
    """Concrete engine over a (box_processor, ocr_processor) pair, e.g.
    :class:`~marie_tpu_torch.boxes.craft_box_processor.BoxProcessorCraft`
    and :class:`~marie_tpu_torch.document.trocr_ocr_processor.TrOcrProcessor`.

    ``page_fuse_batch`` same-bucket pages run as one group;
    ``compact_slots`` is each page's share of its group's recognition
    rows; ``upload_format`` is ``"u8"`` or a packed grayscale format
    (``"u4"``, ``"u2"``, ``"u1"``, ``"u1d"``).  ``classifier`` and
    ``indexer`` (both or neither, as in the JAX engine: one alone is not
    run) are a :class:`LayoutDocumentClassifier` and a
    :class:`LayoutDocumentIndexer` on the processors' device, trained
    with the :class:`RollingWordTokenizer`."""

    #: ``extract`` takes ``on_result_group`` / ``group_size``
    supports_result_stream = True

    @property
    def trained(self) -> Dict[str, Optional[str]]:
        """The zoo tree each model was loaded from, by role (None: seeded
        weights); the heads appear when the engine chains them."""
        parts = {"detector": self.box_processor, "recognizer": self.ocr_processor}
        if self.classifier is not None and self.indexer is not None:
            parts.update(classifier=self.classifier, indexer=self.indexer)
        return {role: getattr(part, "zoo_name", None) for role, part in parts.items()}

    def __init__(
        self,
        box_processor,
        ocr_processor,
        single_program: bool = True,
        page_fuse_batch: int = 16,
        rec_slots: int = 256,
        compact_slots: int = 192,
        upload_format: str = "u8",
        mesh=None,
        classifier=None,
        indexer=None,
    ):
        super().__init__()
        self.mesh = resolve_mesh(mesh, getattr(box_processor, "device", "cuda"))
        if upload_format not in UPLOAD_FORMATS:
            raise ValueError(f"upload_format must be one of {UPLOAD_FORMATS}, "
                             f"got {upload_format!r}")
        self.box_processor = box_processor
        self.ocr_processor = ocr_processor
        self.single_program = single_program
        self.page_fuse_batch = page_fuse_batch
        self.rec_slots = rec_slots
        self.compact_slots = compact_slots
        self.upload_format = upload_format
        self.classifier = classifier
        self.indexer = indexer

    def extract(
        self,
        frames,
        pms_mode: PSMode = PSMode.SPARSE,
        coordinate_format: CoordinateFormat = CoordinateFormat.XYWH,
        regions=None,
        queue_id: str = "",
        **kwargs,
    ) -> List[Dict[str, Any]]:
        """One result dict per page of ``frames`` (uint8 [H, W] or
        [H, W, 3|4] pages of any size, or a list or stack of them); with
        ``regions``, one dict per region (``id``, ``text``, ``confidence``,
        ``words``).

        ``on_result_group(results, start)`` receives each page group's
        results as soon as they are assembled (fused path);
        ``group_size`` overrides ``page_fuse_batch`` for this call."""
        frames = _as_frame_list(frames)
        if regions:
            return self._extract_regions(frames, coordinate_format, regions, queue_id,
                                         **kwargs)
        return self._extract_fullpage(frames, pms_mode, coordinate_format, queue_id,
                                      **kwargs)

    def _extract_fullpage(self, frames, pms_mode, coordinate_format, queue_id, **kwargs):
        """SPARSE and LINE: the fused path, or the two-phase one when the
        processors do not fit it, or host fragments for a detector that
        only has ``detect_words``; the other modes: host fragments."""
        bp, op = self.box_processor, self.ocr_processor
        page_resident = hasattr(bp, "detect_with_page") and hasattr(op, "recognize_dispatch")
        if pms_mode in (PSMode.SPARSE, PSMode.LINE) and page_resident:
            if self.single_program and supports_fused_page(bp, op):
                return self._extract_fused(frames, pms_mode, coordinate_format, **kwargs)
            return self._extract_two_phase(frames, pms_mode, coordinate_format)
        return self._extract_fragments(frames, pms_mode, coordinate_format, queue_id,
                                       kwargs.get("checksum", ""))

    def _extract_fused(self, frames, pms_mode, coordinate_format, **kwargs):
        """Upload | device | collect, streamed: group i's collect runs while
        later groups upload and run."""
        on_result_group = kwargs.get("on_result_group")
        group_size = kwargs.get("group_size") or self.page_fuse_batch
        results: List[Dict[str, Any]] = []
        for handle in fused_dispatch_stream(
            self.box_processor, self.ocr_processor, frames,
            rec_slots=self.rec_slots, page_batch=group_size,
            compact_slots=self.compact_slots, upload_format=self.upload_format,
            mesh=self.mesh, chain=(None if self.classifier is None or self.indexer is None
                   else (self.classifier, self.indexer)),
        ):
            n = handle_page_count(handle)
            start = len(results)
            pages = fused_collect_many(self.box_processor, self.ocr_processor,
                                       [handle], [pms_mode] * n)
            for j, page in enumerate(pages):
                results.append(self._assemble_result(
                    frames[start + j], start + j, page, coordinate_format))
            if on_result_group is not None:
                on_result_group(results[start:], start)
        return results

    def _detect_pages(self, frames, pms_mode):
        """Dispatch every page's detection, fetch all stats at once and
        organize each page's boxes: [(handle, (boxes, scores, lines,
        line_bboxes))] per page; a handle holds the device page and its
        scale for the recognisers' dispatch."""
        bp = self.box_processor
        handles = [bp.detect_dispatch(f) for f in frames]
        stats_host = None
        if len(handles) > 1:
            stacked = {k: torch.stack([h[0][k] for h in handles]).cpu().numpy()
                       for k in handles[0][0]}
            stats_host = [{k: v[i] for k, v in stacked.items()}
                          for i in range(len(handles))]
        pages = []
        for i, (frame, handle) in enumerate(zip(frames, handles)):
            raw_boxes, scores = bp.detect_collect(
                handle, stats=None if stats_host is None else stats_host[i])
            pages.append((handle, bp.organize_boxes(raw_boxes, scores, frame.shape[:2],
                                                    pms_mode)))
        return pages

    def _detect_with_pages(self, frames, pms_mode):
        """:meth:`_detect_pages` for a detector without ``detect_dispatch``:
        ``detect_with_page`` on each page as RGB, as the JAX engine calls
        it; the handles hold (None, device page, scale)."""
        bp = self.box_processor
        pages = []
        for frame in frames:
            raw_boxes, scores, page_dev, scale = bp.detect_with_page(np_rgb(frame))
            pages.append(((None, page_dev, scale),
                          bp.organize_boxes(raw_boxes, scores, frame.shape[:2], pms_mode)))
        return pages

    def _extract_two_phase(self, frames, pms_mode, coordinate_format):
        """Detect every page (dispatching every page's detection first and
        fetching all stats at once, where the detector can), organize the
        boxes, dispatch every page's recognition from its device page, then
        fetch all tokens at once."""
        op = self.ocr_processor
        if hasattr(self.box_processor, "detect_dispatch"):
            pages = self._detect_pages(frames, pms_mode)
        else:
            pages = self._detect_with_pages(frames, pms_mode)
        with launch_path("two_phase"):
            words = op.recognize_collect_many([
                op.recognize_dispatch(handle[1], page[0], handle[2]) for handle, page in pages])
        return [
            self._assemble_result(frame, i, (*page, page_words, None), coordinate_format)
            for i, (frame, (_, page), page_words) in enumerate(zip(frames, pages, words))
        ]

    def _extract_fragments(self, frames, pms_mode, coordinate_format, queue_id, checksum):
        """Cut every page into host fragments by mode, then recognise all
        of them in one batched pass."""
        per_page, fragments = [], []
        for frame in frames:
            boxes, frags, lines, _, line_bboxes = self.box_processor.extract_bounding_boxes(
                queue_id, checksum, frame, pms_mode)
            per_page.append((boxes, None, lines, line_bboxes, len(frags)))
            fragments.extend(frags)
        words = self.ocr_processor.recognize_from_fragments(fragments) if fragments else []
        results, offset = [], 0
        for i, (frame, (*page, n)) in enumerate(zip(frames, per_page)):
            results.append(self._assemble_result(
                frame, i, (*page, words[offset: offset + n], None), coordinate_format))
            offset += n
        return results

    def _extract_regions(self, frames, coordinate_format, regions, queue_id, **kwargs):
        """Each region (``id``, ``pageIndex``, ``x``, ``y``, ``w``, ``h``;
        ``mode``, default RAW_LINE) is cut out of its page and extracted
        in its own mode; its words' text joins with spaces and its
        confidence is their mean, rounded to 4 places."""
        output = []
        for region in regions:
            missing = {"id", "pageIndex", "x", "y", "w", "h"} - set(region)
            if missing:
                raise ValueError(f"Required key missing in region: {region}")
            page_idx = int(region["pageIndex"])
            if page_idx >= len(frames):
                raise ValueError(f"region pageIndex {page_idx} out of range")
            x, y, w, h = (int(region[k]) for k in ("x", "y", "w", "h"))
            snippet = frames[page_idx][max(y, 0): y + h, max(x, 0): x + w]
            mode = PSMode.from_value(region.get("mode", "raw_line"))
            words = self._extract_fullpage([snippet], mode, coordinate_format, queue_id,
                                           **kwargs)[0]["words"]
            conf = float(np.mean([wd["confidence"] for wd in words])) if words else 0.0
            output.append({
                "id": region["id"],
                "text": " ".join(wd["text"] for wd in words),
                "confidence": round(conf, 4),
                "words": words,
            })
        return output

    def _assemble_result(self, frame, index: int, page,
                         coordinate_format: CoordinateFormat) -> Dict[str, Any]:
        """One page tuple -> the result schema (with the chained heads'
        ``classification`` and per-word ``ner_label``)."""
        boxes, _scores, lines, line_bboxes, words, extra = page
        result = finish_result(
            assemble_page_result((frame.shape[0], frame.shape[1]), boxes, lines, words),
            index, lines, line_bboxes, coordinate_format)
        if extra is not None and "classification" in extra:
            cls = dict(extra["classification"])
            labels = getattr(self.classifier, "labels", None)
            if labels and cls["label_id"] < len(labels):
                cls["label"] = labels[cls["label_id"]]
            result["classification"] = cls
            ner_labels = getattr(self.indexer, "labels", None)
            if ner_labels:
                for word in result["words"]:
                    lid = word.get("ner_label_id")
                    if lid is not None and lid < len(ner_labels):
                        word["ner_label"] = ner_labels[lid]
        return result


def finish_result(result: Dict[str, Any], index: int, lines, line_bboxes,
                  coordinate_format: CoordinateFormat) -> Dict[str, Any]:
    """Complete an assembled page result: word boxes as xyxy when asked
    for, and ``meta``'s ``page``, ``lines``, ``lines_bboxes`` and
    ``format``."""
    if coordinate_format == CoordinateFormat.XYXY:
        for word in result["words"]:
            x, y, w, h = word["box"]
            word["box"] = [x, y, x + w, y + h]
    result["meta"]["page"] = index
    result["meta"]["lines"] = _tolist(lines)
    result["meta"]["lines_bboxes"] = _tolist(line_bboxes)
    result["meta"]["format"] = coordinate_format.name.lower()
    return result


def _as_frame_list(frames) -> List[np.ndarray]:
    """[H, W] / [H, W, 3|4] -> one page; [P, H, W] / [P, H, W, C] or a
    list -> pages."""
    if isinstance(frames, np.ndarray):
        if frames.ndim == 2 or (frames.ndim == 3 and frames.shape[-1] in (3, 4)):
            return [frames]
    return list(frames)


def _tolist(arr):
    if isinstance(arr, np.ndarray):
        return arr.tolist()
    return list(arr)
