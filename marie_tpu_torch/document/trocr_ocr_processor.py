"""TrOCR recogniser processor (port of
``marie_tpu/document/trocr_ocr_processor.py``): word boxes on a page that
is already on the device are cropped there (K1) and decoded greedily, in
chunks padded to a few fixed batch sizes.

Left for later: ``beam_size > 1`` (beam search, ROADMAP §1 item 9) and
``recognize_from_fragments`` (host fragments resized with cv2, item 8).
"""

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from marie_tpu_torch.document.ocr_processor import OcrProcessor
from marie_tpu_torch.models.configs import TrOCRConfig
from marie_tpu_torch.models.tokenizer import CharTokenizer
from marie_tpu_torch.models.trocr import greedy_decode
from marie_tpu_torch.ops.kernels.crop_resize import crop_resize
from marie_tpu_torch.preprocess.buckets import pad_batch
from marie_tpu_torch.registry.convert import init_flax_layout, load_model
from marie_tpu_torch.utils.device import resolve_device


@torch.no_grad()
def _crop_and_decode(model, page_u8: torch.Tensor, boxes_xyxy: torch.Tensor,
                     out_h: int, out_w: int, dtype: torch.dtype,
                     max_steps: Optional[int]):
    """Cut crops from the grayscale page on the device (K1, every box on
    page 0), expand them to 3 channels and decode them greedily to
    ``max_steps`` with no step caps -> (tokens, conf).  The JAX version
    crops the page's three equal channels; the crops are the same."""
    n = boxes_xyxy.shape[0]
    with record_function("marie.crop"):
        crops, _ = crop_resize(
            page_u8[None], torch.zeros(n, dtype=torch.int32, device=page_u8.device),
            boxes_xyxy, out_h, out_w)
        crops = crops[..., None].expand(*crops.shape, 3)
    tokens, _, conf = greedy_decode(model, crops.to(dtype), max_steps)
    return tokens, conf


class TrOcrProcessor(OcrProcessor):
    """Greedy TrOCR over word boxes of device pages (the JAX package's
    ``TrOcrProcessor``).  ``params`` is a flax-layout numpy tree; without
    one the weights are drawn from seed 1.  Port-only keyword: ``device``."""

    def __init__(
        self,
        config: Optional[TrOCRConfig] = None,
        params=None,
        tokenizer: Optional[CharTokenizer] = None,
        beam_size: int = 1,
        batch_sizes: Sequence[int] = (8, 32, 128),
        param_dtype: str = "float32",
        decode_steps: Optional[int] = None,
        *,
        device="cuda",
    ):
        if beam_size != 1:
            raise NotImplementedError(
                "beam_size > 1 needs beam search, ROADMAP §1 item 9")
        if param_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"param_dtype must be float32 or bfloat16, got {param_dtype!r}")
        self.device = resolve_device(device)
        self.config = config or TrOCRConfig.fast_v3_g2_d6()
        self.tokenizer = tokenizer or CharTokenizer()
        self.beam_size = beam_size
        self.batch_sizes = tuple(batch_sizes)
        self.crop_h, self.crop_w = self.config.encoder.image_size
        if decode_steps is None:
            # crops are stretched to full height; a glyph is ~0.5*h wide,
            # so the width bound caps the character count
            max_chars = max(self.crop_w // max(self.crop_h // 2, 1), 4)
            decode_steps = min(max_chars + 4, self.config.decoder.max_len)
        self.decode_steps = decode_steps
        self.compute_dtype = torch.bfloat16 if param_dtype == "bfloat16" else torch.float32
        if params is None:
            params = init_flax_layout(self.config, 1)
        self.model = load_model(self.config, params, self.device, self.compute_dtype)

    def warmup(self, page_hw=None, batch_sizes=None) -> None:
        """Run the decode once for every configured batch size (builds the
        kernels and lets cuDNN and cuBLAS pick their algorithms before the
        first request); with ``page_hw`` through the crop of a page of
        that bucket too."""
        for bs in batch_sizes or self.batch_sizes:
            if page_hw is not None:
                page = torch.zeros(page_hw, dtype=torch.uint8, device=self.device)
                boxes = torch.tensor([[0.0, 0.0, 8.0, 8.0]], device=self.device).repeat(bs, 1)
                _crop_and_decode(self.model, page, boxes, self.crop_h, self.crop_w,
                                 self.compute_dtype, self.decode_steps)
            else:
                imgs = torch.zeros(bs, self.crop_h, self.crop_w, 3,
                                   dtype=self.compute_dtype, device=self.device)
                greedy_decode(self.model, imgs)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def recognize_from_page(self, page_dev: torch.Tensor, boxes_xywh: np.ndarray,
                            scale: float = 1.0) -> List[Dict[str, Any]]:
        """Crops are cut on the device from the page the detector
        uploaded; only the box array goes up and the tokens come back."""
        return self.recognize_collect(self.recognize_dispatch(page_dev, boxes_xywh, scale))

    def recognize_dispatch(self, page_dev: torch.Tensor, boxes_xywh, scale: float = 1.0):
        """Launch crop + decode for all chunks of ``boxes_xywh`` (original
        page coordinates; ``scale`` maps them onto the padded page): each
        chunk of at most ``batch_sizes[-1]`` boxes is padded to a
        configured batch size with dummy 1x1 boxes."""
        n = len(boxes_xywh)
        if n == 0:
            return []
        if page_dev.ndim != 2:
            raise ValueError("recognize_dispatch takes the grayscale [H, W] device page")
        xyxy = np.asarray(boxes_xywh, np.float32) * scale
        xyxy = np.stack(
            [xyxy[:, 0], xyxy[:, 1], xyxy[:, 0] + xyxy[:, 2], xyxy[:, 1] + xyxy[:, 3]],
            axis=-1,
        )
        max_bs = self.batch_sizes[-1]
        futures = []
        for start in range(0, n, max_bs):
            chunk = xyxy[start: start + max_bs]
            bs = pad_batch(len(chunk), self.batch_sizes)
            padded = np.zeros((bs, 4), np.float32)
            padded[:, 2:] = 1.0  # dummy 1x1 boxes for pad rows
            padded[: len(chunk)] = chunk
            tokens, conf = _crop_and_decode(
                self.model, page_dev, torch.from_numpy(padded).to(page_dev.device),
                self.crop_h, self.crop_w, self.compute_dtype, self.decode_steps)
            futures.append((len(chunk), tokens, conf))
        return futures

    def recognize_collect(self, futures) -> List[Dict[str, Any]]:
        return self.recognize_collect_many([futures])[0]

    def recognize_collect_many(self, futures_lists) -> List[List[Dict[str, Any]]]:
        """Collect many pages' dispatched chunks with one device-to-host
        copy: the token and confidence arrays are concatenated on the
        device first."""
        flat = [f for fl in futures_lists for f in fl]
        if not flat:
            return [[] for _ in futures_lists]
        tokens = torch.cat([t for (_, t, _) in flat]).cpu().numpy()
        conf = torch.cat([c for (_, _, c) in flat]).cpu().numpy()
        texts = self.tokenizer.decode_batch(tokens)

        out_all: List[List[Dict[str, Any]]] = []
        row = 0
        for fl in futures_lists:
            page_out: List[Dict[str, Any]] = []
            for n_chunk, tok_dev, _ in fl:
                for r in range(n_chunk):
                    page_out.append(
                        {"text": texts[row + r], "confidence": float(conf[row + r])})
                row += tok_dev.shape[0]
            out_all.append(page_out)
        return out_all

    def recognize_from_fragments(self, fragments):
        raise NotImplementedError(
            "recognition of host fragments resizes them with cv2; it is "
            "ROADMAP §1 item 8")
