"""ClassificationPipeline — OCR (reused when given or cached) +
classification + optional split into documents (port of
``marie_tpu/pipe/classification_pipeline.py``; upstream marie's
``marie/pipe/classification_pipeline.py``).

OCR results are cached as JSON in the asset directory keyed by the
frames' checksum (``utils/image_utils.py::hash_frames_fast``, the JAX
package's key, so either package reads the other's cache) and mirrored
to primary storage (``*.json``), so re-classifying the same document
skips the OCR stage.  The engine and the heads run where they were built
(the card unless they were given ``device="cpu"``); the pipeline itself
is host code.
"""

import json
import os
import tempfile
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from marie_tpu_torch.components.base import PageInput
from marie_tpu_torch.enums import CoordinateFormat, PSMode
from marie_tpu_torch.helper import ensure_exists
from marie_tpu_torch.logging_core import TimeContext
from marie_tpu_torch.pipe.assets import restore_assets, store_assets
from marie_tpu_torch.pipe.base_pipeline import BasePipeline
from marie_tpu_torch.utils.image_utils import hash_frames_fast


class ClassificationPipeline(BasePipeline):
    def __init__(
        self,
        ocr_engine=None,
        classifiers: Optional[Sequence] = None,
        splitter=None,
        work_dir: Optional[str] = None,
        **kwargs,
    ):
        super().__init__(classifiers=classifiers, **kwargs)
        self.ocr_engine = ocr_engine
        self.splitter = splitter
        # the JAX default, /tmp/generators, under this process's temp dir
        self.work_dir = work_dir or os.path.join(tempfile.gettempdir(), "generators")

    def execute(
        self,
        ref_id: str,
        ref_type: str,
        frames: List[np.ndarray],
        ocr_results: Optional[List[Dict[str, Any]]] = None,
        job_id: str = "",
        runtime_conf: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        frames = [np.asarray(f) for f in frames]
        root_asset_dir = ensure_exists(
            os.path.join(self.work_dir, hash_frames_fast(frames))
        )
        ocr_cache = os.path.join(root_asset_dir, "results", "ocr.json")
        if ocr_results is None:
            # reuse a prior run's OCR: local cache first, then a partial
            # restore of */results/*.json from primary storage
            if not os.path.exists(ocr_cache):
                restore_assets(ref_id, ref_type, root_asset_dir)
            if os.path.exists(ocr_cache):
                try:
                    with open(ocr_cache) as fp:
                        ocr_results = json.load(fp)
                    self.logger.info(f"Reusing cached OCR for {ref_id}")
                except Exception as ex:  # noqa: BLE001 — fall through to OCR
                    self.logger.warning(f"ocr cache load failed: {ex!r}")
        if ocr_results is None:
            if self.ocr_engine is None:
                raise ValueError("no ocr_results given and no ocr_engine configured")
            with TimeContext("ocr", self.logger):
                ocr_results = self.ocr_engine.extract(
                    frames, PSMode.SPARSE, CoordinateFormat.XYWH
                )
            try:
                ensure_exists(os.path.dirname(ocr_cache))

                def _native(o):
                    # keep numbers numbers across the round trip
                    if isinstance(o, np.generic):
                        return o.item()
                    if isinstance(o, np.ndarray):
                        return o.tolist()
                    return str(o)

                with open(ocr_cache, "w") as fp:
                    json.dump(ocr_results, fp, default=_native)
                store_assets(ref_id, ref_type, root_asset_dir,
                             match_wildcard="*.json")
            except Exception as ex:  # noqa: BLE001 — caching is best-effort
                self.logger.warning(f"ocr cache save failed: {ex!r}")

        metadata: Dict[str, Any] = {
            "ref_id": ref_id,
            "ref_type": ref_type,
            "job_id": job_id,
            "pages": len(frames),
            "pipeline": type(self).__name__,
            "ocr": ocr_results,
        }
        self.execute_classifier_and_indexer_pipeline(
            frames, ocr_results, metadata, True, False
        )

        if self.splitter is not None:
            pages = [
                PageInput.from_ocr_result(r, f) for r, f in zip(ocr_results, frames)
            ]
            split = self.splitter.split(pages)
            metadata["splitter"] = split
            metadata["documents"] = type(self.splitter).to_documents(split)
        return metadata
