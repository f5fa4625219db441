"""TextExtractionExecutor (port of
``marie_tpu/executor/text_extraction_executor.py``): the OCR workload's
``/document/extract`` endpoint.

It loads the frames of a request (document tensors, else the files their
``uri`` or ``asset_key`` tag name), runs the port's
:class:`ExtractPipeline` on them and answers the JAX executor's envelope:
``{"status": "succeeded", "runtime_info": {"elapsed", "pages"},
"metadata"}``, or ``{"status": "failed", "error"}``.  The pipeline's OCR
engine comes from :func:`get_known_ocr_engines` on ``device`` (the card
by default); the overlay cleanup joins it only with a trained generator
(the zoo's ``pix2pix-synth``), as in the JAX executor.
``/document/status`` reports :func:`get_full_version` of the serving
process.
"""

import time
from typing import Any, Dict, Optional

import numpy as np

from marie_tpu_torch.enums import CoordinateFormat, PSMode
from marie_tpu_torch.executor.storage import StorageMixin
from marie_tpu_torch.logging_core import MDC
from marie_tpu_torch.serve.executors import BaseExecutor
from marie_tpu_torch.serve.executors.decorators import requests, safely_encoded
from marie_tpu_torch.types.docs import DocumentArray


def _frames_from_docs_or_assets(docs: DocumentArray):
    from marie_tpu_torch.utils.docs import frames_from_file

    frames = []
    for doc in docs:
        if doc.tensor is not None:
            arr = np.asarray(doc.tensor).astype(np.uint8)
            if arr.ndim == 2:
                arr = np.stack([arr] * 3, -1)
            frames.append(arr)
        elif doc.uri:
            frames.extend(frames_from_file(doc.uri))
        elif doc.tags.get("asset_key"):
            frames.extend(frames_from_file(doc.tags["asset_key"]))
    return frames


def _trained_overlay(device):
    """The overlay processor when the zoo holds its trained generator,
    else None (a seeded generator is not built to be dropped)."""
    from marie_tpu_torch.overlay.overlay import ZOO_TREE, OverlayProcessor
    from marie_tpu_torch.registry.zoo import zoo_checkpoint

    if zoo_checkpoint(ZOO_TREE) is None:
        return None
    return OverlayProcessor(device=device)


class TextExtractionExecutor(StorageMixin, BaseExecutor):
    def __init__(
        self,
        pipeline=None,
        ocr_engine: Optional[str] = "default",
        work_dir: Optional[str] = None,
        storage_enabled: bool = False,
        storage_conf: Optional[Dict[str, Any]] = None,
        device="cuda",
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.setup_storage(storage_enabled, storage_conf, silence_exceptions=True)
        if pipeline is None:
            from marie_tpu_torch.ocr.util import get_known_ocr_engines
            from marie_tpu_torch.pipe.extract_pipeline import ExtractPipeline

            engine = get_known_ocr_engines(device=device, engine=ocr_engine)[ocr_engine]
            pipeline = ExtractPipeline(ocr_engine=engine, work_dir=work_dir,
                                       overlay_processor=_trained_overlay(device),
                                       device=device)
        self.pipeline = pipeline

    @requests(on="/document/extract")
    @safely_encoded
    def extract(self, docs: DocumentArray, parameters: Dict[str, Any], **kwargs):
        job_id = str(parameters.get("job_id", ""))
        MDC.put("request_id", job_id)
        try:
            frames = _frames_from_docs_or_assets(docs)
            if not frames:
                return {"status": "failed", "error": "no frames in request"}
            pms_mode = PSMode.from_value(str(parameters.get("mode", "sparse")))
            coord = CoordinateFormat(str(parameters.get("output_format", "xywh")).lower())
            regions = parameters.get("regions") or None
            ref_id = str(parameters.get("ref_id", docs[0].id if len(docs) else ""))
            ref_type = str(parameters.get("ref_type", "doc"))
            t0 = time.time()
            metadata = self.pipeline.execute(
                ref_id=ref_id, ref_type=ref_type, frames=frames, pms_mode=pms_mode,
                coordinate_format=coord, regions=regions, job_id=job_id,
                runtime_conf=parameters.get("features", {}) or {},
            )
            if self.storage_enabled:
                from marie_tpu_torch.api.docs import StorageDoc
                from marie_tpu_torch.utils.image_utils import hash_frames_fast

                self.store(
                    ref_id=ref_id, ref_type=ref_type, store_mode="content",
                    docs=[StorageDoc(content=metadata, tags={
                        "action": "extract", "index": -1, "type": "extract_results",
                        "ttl": 48 * 60, "checksum": hash_frames_fast(frames)})],
                )
            return {
                "status": "succeeded",
                "runtime_info": {"elapsed": round(time.time() - t0, 3), "pages": len(frames)},
                "metadata": metadata,
            }
        except Exception as ex:  # noqa: BLE001 — reported in the envelope
            self.logger.error(f"extract failed: {ex!r}")
            return {"status": "failed", "error": repr(ex)}
        finally:
            MDC.remove("request_id")

    @requests(on="/document/status")
    def info(self, docs, **kwargs):
        from marie_tpu_torch.helper import get_full_version

        return {"status": "OK", "runtime_info": get_full_version()}


class TextExtractionExecutorMock(BaseExecutor):
    """Canned OCR results (:class:`MockOcrEngine`), for stock
    configurations and tests."""

    @requests(on="/document/extract")
    @safely_encoded
    def extract(self, docs: DocumentArray, parameters: Dict[str, Any], **kwargs):
        from marie_tpu_torch.ocr.mock_ocr_engine import MockOcrEngine

        frames = _frames_from_docs_or_assets(docs)
        if not frames:
            frames = [np.full((64, 64, 3), 255, np.uint8)]
        results = MockOcrEngine().extract(frames)
        return {
            "status": "succeeded",
            "runtime_info": {"mock": True, "pages": len(frames)},
            "metadata": {"ocr": results},
        }
