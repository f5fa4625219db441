"""ExtractPipeline — the full document job (port of
``marie_tpu/pipe/extract_pipeline.py``; upstream marie's
``marie/pipe/extract_pipeline.py``): burst the pages, clean form
overlays, OCR, classify and index, render the text, searchable-PDF,
BLOBS and Adlib artifacts, pack the delivery assets and store them, all
rooted in a checksum-keyed asset directory that a rerun of the same
document reuses.  Runtime feature flags follow upstream's
``runtime_conf`` shape (``page_classifier.enabled`` ...).  Two optional
stages run as in the JAX pipeline: boundary registration before the
overlay (``page_boundary``, off by default: each frame is replaced by the
registered page, the predictions go to ``metadata["boundary"]``), and
template matching on the cleaned frames after OCR (``template_matching``,
on when a matcher is given).

The engine, the overlay, the registration, the matchers and the heads
run where they were built (the card unless they were given
``device="cpu"``); the pipeline's own threads (burst, ``results.tif``,
render) are host code on numpy frames and result dicts and touch no CUDA
tensor.  Files go through :mod:`marie_tpu_torch.utils.image_io` (PNG,
TIFF, JPEG in numpy), not PIL.
"""

import json
import os
import queue
import shutil
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
from torch.profiler import record_function

from marie_tpu_torch.enums import CoordinateFormat, PSMode
from marie_tpu_torch.helper import ensure_exists
from marie_tpu_torch.logging_core import MDC, TimeContext
from marie_tpu_torch.pipe.assets import (
    burst_frames,
    get_file_count,
    restore_assets,
    save_frame,
    split_filename,
    store_assets,
)
from marie_tpu_torch.pipe.base_pipeline import BasePipeline
from marie_tpu_torch.utils.device import resolve_device
from marie_tpu_torch.utils.image_utils import ensure_max_page_size, hash_frames_fast


def _in_layout(img: np.ndarray, like: np.ndarray) -> np.ndarray:
    """A read-back page in the incoming frame's channel layout: RGB to
    gray as PIL's ``convert("L")`` (ITU-R 601-2 in 16-bit fixed point),
    gray to RGB by stacking."""
    if np.asarray(like).ndim == 2 and img.ndim == 3:
        x = img.astype(np.int32)
        return ((x[..., 0] * 19595 + x[..., 1] * 38470 + x[..., 2] * 7471 + 0x8000)
                >> 16).astype(np.uint8)
    if np.asarray(like).ndim == 3 and img.ndim == 2:
        return np.stack([img] * 3, axis=-1)
    return img


class ExtractPipeline(BasePipeline):
    def __init__(
        self,
        ocr_engine=None,
        classifiers: Optional[Sequence] = None,
        indexers: Optional[Sequence] = None,
        overlay_processor=None,
        boundary_processor=None,
        template_matcher=None,
        work_dir: Optional[str] = None,
        renderers: Sequence[str] = ("text", "pdf", "blobs", "adlib"),
        device="cuda",
        **kwargs,
    ):
        super().__init__(classifiers=classifiers, indexers=indexers, **kwargs)
        self.template_matcher = template_matcher
        self.boundary_processor = boundary_processor
        self.device = resolve_device(device)
        if ocr_engine is None:
            from marie_tpu_torch.ocr.default_ocr_engine import DefaultOcrEngine

            ocr_engine = DefaultOcrEngine(device=self.device)
        self.ocr_engine = ocr_engine
        self.overlay_processor = overlay_processor
        # the JAX default, /tmp/generators, under this process's temp dir
        self.work_dir = work_dir or os.path.join(tempfile.gettempdir(), "generators")
        self.renderers = tuple(renderers)

    # ------------------------------------------------------------------
    def execute(
        self,
        ref_id: str,
        ref_type: str,
        frames: List[np.ndarray],
        pms_mode: PSMode = PSMode.SPARSE,
        coordinate_format: CoordinateFormat = CoordinateFormat.XYWH,
        regions: Optional[List[Dict[str, Any]]] = None,
        queue_id: str = "",
        job_id: str = "",
        runtime_conf: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        if ref_id is None or ref_type is None:
            raise ValueError("Invalid reference type or id")
        runtime_conf = runtime_conf or {}
        frames = [np.asarray(f) for f in frames]

        checksum = hash_frames_fast(frames)
        root_asset_dir = os.path.join(self.work_dir, checksum)
        # the asset dir is checksum-keyed and reused across runs of the
        # same document: stages whose outputs already exist are skipped
        ensure_exists(root_asset_dir)

        MDC.put("request_id", job_id or checksum[:8])
        if regions:
            return self.execute_regions_pipeline(
                ref_id, ref_type, frames, regions, root_asset_dir,
                pms_mode, coordinate_format, job_id, runtime_conf,
            )
        return self.execute_frames_pipeline(
            ref_id, ref_type, frames, root_asset_dir, job_id,
            pms_mode, coordinate_format, runtime_conf,
        )

    # ------------------------------------------------------------------
    def execute_frames_pipeline(
        self,
        ref_id: str,
        ref_type: str,
        frames: List[np.ndarray],
        root_asset_dir: str,
        job_id: str,
        pms_mode: PSMode = PSMode.SPARSE,
        coordinate_format: CoordinateFormat = CoordinateFormat.XYWH,
        runtime_conf: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        runtime_conf = runtime_conf or {}

        def flag(name: str, default: bool) -> bool:
            return bool(runtime_conf.get(name, {}).get("enabled", default))

        classifier_enabled = flag("page_classifier", True)
        indexer_enabled = flag("page_indexer", True)
        # overlay cleanup runs by default, as upstream's standard segment
        # stage; the blend is mask-gated, so clean pages pass unchanged
        cleaner_enabled = flag("page_cleaner", True)
        boundary_enabled = flag("page_boundary", False)

        metadata: Dict[str, Any] = {
            "ref_id": ref_id,
            "ref_type": ref_type,
            "job_id": job_id,
            "pages": len(frames),
            "pipeline": type(self).__name__,
        }

        # clamp oversized pages
        frames = [ensure_max_page_size(f)[0] for f in frames]

        # restore prior-run assets from primary storage (best-effort);
        # before _segment, whose resume logic reads the restored clean/
        restore_assets(ref_id, ref_type, root_asset_dir)
        # bursting pages to numbered files is host file IO consumed only
        # by _pack_assets, so it overlaps the device stages below
        def _burst():
            with record_function("marie.burst"):
                burst_frames(ref_id, frames, root_asset_dir)

        burst_thread = threading.Thread(target=_burst, name="burst")
        burst_thread.start()

        stage_times: Dict[str, float] = {}
        if boundary_enabled and self.boundary_processor is not None:
            # the registered pages go into a new list: the burst thread
            # writes the incoming ones
            frames = list(frames)
            with TimeContext("boundary", self.logger) as tc, record_function("marie.boundary"):
                boundary_meta = []
                for i, f in enumerate(frames):
                    res = self.boundary_processor.run(f)
                    boundary_meta.append({"page": i, **res.get("meta", {})})
                    frames[i] = res.get("aligned", f)
                metadata["boundary"] = boundary_meta
            stage_times["boundary"] = round(tc.duration, 4)
        metadata["stage_times_s"] = stage_times

        clean_frames = frames
        if cleaner_enabled and self.overlay_processor is not None:
            with TimeContext("segment", self.logger) as tc, record_function("marie.segment"):
                clean_frames = self._segment(ref_id, frames, root_asset_dir)
            stage_times["segment"] = round(tc.duration, 4)

        # results.tif encodes once from the in-memory clean frames on a
        # thread overlapped with OCR; pack hardlinks the delivery names to it
        tif_err: List[BaseException] = []

        def _results_tif():
            try:
                from marie_tpu_torch.utils.docs import save_frames_as_tiff

                with record_function("marie.tiff"):
                    save_frames_as_tiff(
                        clean_frames, os.path.join(root_asset_dir, "results.tif")
                    )
            except Exception as exc:  # noqa: BLE001 — re-checked in pack
                tif_err.append(exc)

        tif_thread = threading.Thread(target=_results_tif, name="results-tif")
        tif_thread.start()

        # streamed OCR -> render: the engine hands over each page group's
        # results as soon as they exist, so the host-bound renderers (JPEG,
        # zlib, XML) run while the card executes later groups
        render_err: List[BaseException] = []
        render_q: "queue.Queue" = queue.Queue()

        def _render_consumer():
            try:
                renderers = self._renderer_instances(root_asset_dir)
                for r, out in renderers:
                    r.begin(out)
                while True:
                    item = render_q.get()
                    if item is None:
                        break
                    chunk_frames, chunk_results, start = item
                    chunk_results = self._xywh_copy(chunk_results)
                    with record_function("marie.render"):
                        for r, out in renderers:
                            r.feed(chunk_frames, chunk_results, start)
                with record_function("marie.render"):
                    for r, out in renderers:
                        r.finish()
            except Exception as exc:  # noqa: BLE001 — re-raised on join
                render_err.append(exc)

        render_thread = threading.Thread(target=_render_consumer, name="render")
        render_thread.start()

        streaming = bool(getattr(self.ocr_engine, "supports_result_stream", False))
        try:
            with TimeContext("ocr", self.logger) as tc:
                if streaming:
                    chunk = int(os.environ.get("MARIE_PIPE_OCR_CHUNK", "8"))
                    fed = [0]  # pages already handed to the render queue

                    def _on_group(res, start):
                        render_q.put((frames[start:start + len(res)], res, start))
                        fed[0] = start + len(res)

                    ocr_results = self.ocr_engine.extract(
                        clean_frames, pms_mode, coordinate_format,
                        on_result_group=_on_group, group_size=chunk,
                    )
                    if fed[0] < len(ocr_results):
                        # the engine took a path that does not stream
                        render_q.put((frames[fed[0]:], ocr_results[fed[0]:], fed[0]))
                else:
                    ocr_results = self.ocr_engine.extract(
                        clean_frames, pms_mode, coordinate_format
                    )
                    render_q.put((frames, ocr_results, 0))
            stage_times["ocr"] = round(tc.duration, 4)
        finally:
            render_q.put(None)  # always unblock the consumer
        metadata["ocr"] = ocr_results
        render_t0 = time.perf_counter()

        if self.template_matcher is not None and flag("template_matching", True):
            with TimeContext("template-matching", self.logger) as tc, \
                    record_function("marie.template_matching"):
                matches = self.template_matcher.match(clean_frames)
                metadata["template_matching"] = [
                    {"frame_index": m.frame_index, "label": m.label, "bbox": m.bbox,
                     "score": round(m.score, 4)}
                    for m in matches
                ]
            stage_times["template_matching"] = round(tc.duration, 4)

        with TimeContext("classify-index", self.logger) as tc, \
                record_function("marie.classify_index"):
            self.execute_classifier_and_indexer_pipeline(
                frames, ocr_results, metadata, classifier_enabled, indexer_enabled,
            )
        stage_times["classify_index"] = round(tc.duration, 4)

        render_thread.join()
        if render_err:
            raise render_err[0]
        # the tail the render thread ran past the device stages
        stage_times["render_wall"] = round(time.perf_counter() - render_t0, 4)
        burst_thread.join()  # pack consumes the burst/ dir
        tif_thread.join()
        if tif_err:  # fall back to an in-pack encode
            self.logger.warning(f"results.tif thread failed: {tif_err[0]!r}")
        with TimeContext("pack", self.logger) as tc, record_function("marie.pack"):
            self._pack_assets(clean_frames, metadata, root_asset_dir, ref_id)
            metadata["assets"] = self._asset_listing(root_asset_dir)
        stage_times["pack"] = round(tc.duration, 4)
        # mirror the asset tree to primary storage so that a later run of
        # the same ref can restore and skip
        with TimeContext("store", self.logger) as tc:
            store_assets(ref_id, ref_type, root_asset_dir)
        stage_times["store"] = round(tc.duration, 4)
        return metadata

    # ------------------------------------------------------------------
    def _segment(
        self, ref_id: str, frames: List[np.ndarray], root_asset_dir: str
    ) -> List[np.ndarray]:
        """Overlay cleanup with per-page persistence: clean pages are
        written to ``clean/`` as PNG and, when a prior run (local or
        restored) left one file per page, read back instead of running
        the generator again (upstream's skip on a count match)."""
        from marie_tpu_torch.utils.image_io import read_png

        clean_dir = ensure_exists(os.path.join(root_asset_dir, "clean"))
        _, prefix, _ = split_filename(ref_id)
        names = [f"{prefix}_{i:05d}.png" for i in range(len(frames))]
        if get_file_count(clean_dir) == len(frames):
            try:
                files = sorted(
                    n for n in os.listdir(clean_dir)
                    if os.path.isfile(os.path.join(clean_dir, n))
                )
                restored = [_in_layout(read_png(os.path.join(clean_dir, name)), ref)
                            for name, ref in zip(files, frames)]
                if len(restored) == len(frames):
                    self.logger.info(f"Skipping segmentation for {ref_id}")
                    return restored
            except Exception as ex:  # noqa: BLE001 — fall through to a new run
                self.logger.warning(f"clean-asset restore failed: {ex!r}")
        with TimeContext("overlay-cleanup", self.logger):
            clean_frames = self.overlay_processor.segment_batch(frames)
        for name, cf in zip(names, clean_frames):
            try:
                save_frame(np.asarray(cf), os.path.join(clean_dir, name))
            except Exception as ex:  # noqa: BLE001 — persistence is best-effort
                self.logger.warning(f"clean-asset save failed: {ex!r}")
        return list(clean_frames)

    def _pack_assets(
        self, frames, metadata, root_asset_dir: str, ref_id: str = "doc"
    ) -> None:
        """Pack the delivery ``assets/`` dir (upstream's ``pack_assets``):
        the Adlib XMLs zipped as ``{prefix}.ocr.zip``, the BLOBS as
        ``{prefix}.blobs.xml.zip``, the cleaned pages as one multi-page
        TIFF (``{prefix}.tif`` and ``{prefix}.tif.clean``), the searchable
        PDF as ``{prefix}.pdf``, and ``results.tif``/``results.json`` at
        the root for programmatic consumers."""
        from marie_tpu_torch.utils.archive import merge_zip
        from marie_tpu_torch.utils.docs import save_frames_as_tiff

        try:
            results_tif = os.path.join(root_asset_dir, "results.tif")
            if not os.path.exists(results_tif):
                # the pipeline encodes this on a thread overlapped with
                # OCR; this is the fallback
                save_frames_as_tiff(frames, results_tif)
            with open(os.path.join(root_asset_dir, "results.json"), "w") as fp:
                json.dump(metadata.get("ocr", []), fp, default=str)

            assets_dir = ensure_exists(os.path.join(root_asset_dir, "assets"))
            _, prefix, _ = split_filename(ref_id)
            merge_zip(
                os.path.join(root_asset_dir, "adlib"),
                os.path.join(assets_dir, f"{prefix}.ocr.zip"),
            )
            merge_zip(
                os.path.join(root_asset_dir, "blobs"),
                os.path.join(assets_dir, f"{prefix}.blobs.xml.zip"),
            )

            def _link_or_copy(src: str, dst: str) -> None:
                # write-once delivery artifacts on one filesystem:
                # hardlink instead of copying multi-MB TIFFs
                if os.path.exists(dst):
                    os.unlink(dst)
                try:
                    os.link(src, dst)
                except OSError:
                    shutil.copy(src, dst)

            # results.tif holds the clean frames, so the delivery clean
            # tif is a hardlink to it, not a second encode
            clean_tif = os.path.join(assets_dir, f"{prefix}.tif.clean")
            _link_or_copy(results_tif, clean_tif)
            _link_or_copy(clean_tif, os.path.join(assets_dir, f"{prefix}.tif"))
            pdf = os.path.join(root_asset_dir, "results.pdf")
            if os.path.exists(pdf):
                _link_or_copy(pdf, os.path.join(assets_dir, f"{prefix}.pdf"))
        except Exception as ex:  # noqa: BLE001 — packing must not fail the job
            self.logger.error(f"pack_assets failed: {ex!r}")

    # ------------------------------------------------------------------
    def execute_regions_pipeline(
        self,
        ref_id: str,
        ref_type: str,
        frames: List[np.ndarray],
        regions: List[Dict[str, Any]],
        root_asset_dir: str,
        pms_mode: PSMode,
        coordinate_format: CoordinateFormat,
        job_id: str,
        runtime_conf: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        with TimeContext("ocr-regions", self.logger):
            results = self.ocr_engine.extract(
                frames, pms_mode, coordinate_format, regions=regions
            )
        return {
            "ref_id": ref_id,
            "ref_type": ref_type,
            "job_id": job_id,
            "pages": len(frames),
            "regions": results,
        }

    # ------------------------------------------------------------------
    def _renderer_instances(self, root_asset_dir: str):
        """(renderer, output_path) pairs for the enabled artifact set."""
        from marie_tpu_torch.renderer import (
            AdlibRenderer,
            BlobRenderer,
            PdfRenderer,
            TextRenderer,
        )

        out = []
        if "text" in self.renderers:
            out.append((
                TextRenderer({"preserve_interword_spaces": True}),
                os.path.join(root_asset_dir, "results.txt"),
            ))
        if "pdf" in self.renderers:
            out.append((PdfRenderer(), os.path.join(root_asset_dir, "results.pdf")))
        if "blobs" in self.renderers:
            out.append((BlobRenderer(), os.path.join(root_asset_dir, "blobs")))
        if "adlib" in self.renderers:
            out.append((AdlibRenderer(), os.path.join(root_asset_dir, "adlib")))
        return out

    @staticmethod
    def _xywh_copy(ocr_results):
        """Renderers only read the results, except ``check_format_xywh``'s
        in-place xyxy -> xywh conversion: the engine serves xywh, so the
        common path copies nothing, and an xyxy result is converted once on
        a private copy."""
        if any(r.get("meta", {}).get("format") == "xyxy" for r in ocr_results):
            import copy

            from marie_tpu_torch.renderer.renderer import ResultRenderer

            ocr_results = copy.deepcopy(ocr_results)
            for r in ocr_results:
                ResultRenderer.check_format_xywh(r)
        return ocr_results

    @staticmethod
    def _asset_listing(root_asset_dir: str) -> List[str]:
        out = []
        for base, _, files in os.walk(root_asset_dir):
            for f in files:
                out.append(os.path.join(base, f))
        return sorted(out)
