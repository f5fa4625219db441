"""TrOCR recogniser processor (port of
``marie_tpu/document/trocr_ocr_processor.py``): word boxes on a page that
is already on the device are cropped there (K1 on a grayscale page, stock
ops on an RGB one) and decoded greedily or, with ``beam_size > 1``, by
beam search, in chunks padded to a few fixed batch sizes; host fragments
are resized to the crop height with cv2's ``INTER_LINEAR`` arithmetic
(:func:`resize_linear_u8`), grouped into width buckets and decoded in the
same chunks (launches counted on the ``"fragments"`` path).
"""

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from marie_tpu_torch.document.ocr_processor import OcrProcessor
from marie_tpu_torch.models.configs import TrOCRConfig
from marie_tpu_torch.models.tokenizer import CharTokenizer
from marie_tpu_torch.models.trocr import beam_decode, greedy_decode
from marie_tpu_torch.ops.kernels.crop_resize import crop_resize
from marie_tpu_torch.ops.kernels._build import launch_path
from marie_tpu_torch.preprocess.buckets import group_by_bucket, pad_batch
from marie_tpu_torch.preprocess.ops import crop_resize_pages
from marie_tpu_torch.preprocess.resize import resize_linear_u8
from marie_tpu_torch.registry.convert import init_flax_layout, load_model
from marie_tpu_torch.utils.device import resolve_device


def _decode(model, crops: torch.Tensor, beam_size: int, max_steps: Optional[int]):
    """(tokens, lengths, confidences) of greedy decoding to ``max_steps``
    or, with ``beam_size > 1``, of beam search (which ignores
    ``max_steps``, as in the JAX package)."""
    if beam_size > 1:
        return beam_decode(model, crops, beam_size)
    return greedy_decode(model, crops, max_steps)


@torch.no_grad()
def _crop_and_decode(model, page_u8: torch.Tensor, boxes_xyxy: torch.Tensor,
                     out_h: int, out_w: int, dtype: torch.dtype,
                     max_steps: Optional[int], beam_size: int = 1):
    """Cut crops from the page on the device (every box on page 0) and
    decode them (:func:`_decode`, no step caps) -> (tokens, conf).  A
    grayscale [H, W] page crops through K1 and its crops are expanded to
    3 channels (the JAX version crops the page's three equal channels:
    the crops are the same); an RGB [H, W, 3] page crops with stock ops,
    as in the JAX version."""
    n = boxes_xyxy.shape[0]
    page_of = torch.zeros(n, dtype=torch.int32, device=page_u8.device)
    with record_function("marie.crop"):
        if page_u8.ndim == 2:
            crops, _ = crop_resize(page_u8[None], page_of, boxes_xyxy, out_h, out_w)
            crops = crops[..., None].expand(*crops.shape, 3)
        else:
            crops, _ = crop_resize_pages(page_u8[None], page_of, boxes_xyxy, out_h, out_w)
    tokens, _, conf = _decode(model, crops.to(dtype), beam_size, max_steps)
    return tokens, conf


class TrOcrProcessor(OcrProcessor):
    """TrOCR over word boxes of device pages and over host fragments (the
    JAX package's ``TrOcrProcessor``): greedy, or beam search with
    ``beam_size > 1``.  ``params`` is a flax-layout numpy tree; without
    one the weights are drawn from seed 1.  Port-only keyword:
    ``device``."""

    #: the zoo tree the weights came from (None: passed in or seeded)
    zoo_name: Optional[str] = None

    def __init__(
        self,
        config: Optional[TrOCRConfig] = None,
        params=None,
        tokenizer: Optional[CharTokenizer] = None,
        beam_size: int = 1,
        batch_sizes: Sequence[int] = (8, 32, 128),
        width_buckets: Optional[Sequence[int]] = None,
        param_dtype: str = "float32",
        decode_steps: Optional[int] = None,
        *,
        device="cuda",
    ):
        if beam_size < 1:
            raise ValueError(f"beam_size must be >= 1, got {beam_size}")
        if param_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"param_dtype must be float32 or bfloat16, got {param_dtype!r}")
        self.device = resolve_device(device)
        self.config = config or TrOCRConfig.fast_v3_g2_d6()
        self.tokenizer = tokenizer or CharTokenizer()
        self.beam_size = beam_size
        self.batch_sizes = tuple(batch_sizes)
        self.crop_h, self.crop_w = self.config.encoder.image_size
        # width buckets never exceed the encoder's input width
        wb = width_buckets or [self.crop_w // 4, self.crop_w // 2,
                               (3 * self.crop_w) // 4, self.crop_w]
        self.width_buckets = tuple(sorted({min(b, self.crop_w) for b in wb}))
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
                                 self.compute_dtype, self.decode_steps, self.beam_size)
            else:
                imgs = torch.zeros(bs, self.crop_h, self.crop_w, 3,
                                   dtype=self.compute_dtype, device=self.device)
                _decode(self.model, imgs, self.beam_size, None)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def recognize_from_page(self, page_dev: torch.Tensor, boxes_xywh: np.ndarray,
                            scale: float = 1.0) -> List[Dict[str, Any]]:
        """Crops are cut on the device from the page the detector
        uploaded; only the box array goes up and the tokens come back."""
        return self.recognize_collect(self.recognize_dispatch(page_dev, boxes_xywh, scale))

    def recognize_dispatch(self, page_dev: torch.Tensor, boxes_xywh, scale: float = 1.0):
        """Launch crop + decode for all chunks of ``boxes_xywh`` (original
        page coordinates; ``scale`` maps them onto the padded [H, W] or
        [H, W, 3] device page): each
        chunk of at most ``batch_sizes[-1]`` boxes is padded to a
        configured batch size with dummy 1x1 boxes."""
        n = len(boxes_xywh)
        if n == 0:
            return []
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
                self.crop_h, self.crop_w, self.compute_dtype, self.decode_steps,
                self.beam_size)
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

    def _prep_fragment(self, frag: np.ndarray) -> np.ndarray:
        """uint8 fragment -> float32 [crop_h, eff_w <= crop_w, 3] in [0, 1]."""
        if frag.dtype != np.uint8:
            raise ValueError(f"fragments are uint8, got {frag.dtype}")
        if frag.ndim == 2:
            frag = np.stack([frag] * 3, -1)
        fh, fw = frag.shape[:2]
        if fh == 0 or fw == 0:
            return np.full((self.crop_h, 1, 3), 1.0, np.float32)
        scale = self.crop_h / fh
        new_w = max(1, min(int(round(fw * scale)), self.crop_w))
        out = resize_linear_u8(frag, (new_w, self.crop_h)).astype(np.float32)
        if out.max() > 1.5:
            out = out / 255.0
        return out

    def recognize_from_fragments(self, fragments: Sequence[np.ndarray]) -> List[Dict[str, Any]]:
        """Host fragments (uint8 [h, w] or [h, w, 3] cut-outs) -> one word
        dict each: resized to the crop height (aspect kept, at most the
        crop width), grouped by width bucket, chunked at the largest batch
        size and padded white to a configured one."""
        n = len(fragments)
        if n == 0:
            return []
        preps = [self._prep_fragment(f) for f in fragments]
        groups = group_by_bucket([p.shape[1] for p in preps], self.width_buckets)
        out: List[Any] = [None] * n  # every index is in one width group
        max_bs = self.batch_sizes[-1]
        for indices in groups.values():
            # the encoder always takes the full crop width: a bucket pads
            # the content, not the tensor
            for start in range(0, len(indices), max_bs):
                chunk = indices[start: start + max_bs]
                batch = np.full((pad_batch(len(chunk), self.batch_sizes),
                                 self.crop_h, self.crop_w, 3), 1.0, np.float32)
                for row, idx in enumerate(chunk):
                    batch[row, :, : preps[idx].shape[1]] = preps[idx]
                imgs = torch.from_numpy(batch).to(self.device).to(self.compute_dtype)
                with launch_path("fragments"):
                    tokens, _, conf = _decode(self.model, imgs, self.beam_size,
                                              self.decode_steps)
                texts = self.tokenizer.decode_batch(tokens.cpu().numpy())
                conf = conf.cpu().numpy()
                for row, idx in enumerate(chunk):
                    out[idx] = {"text": texts[row], "confidence": float(conf[row])}
        return out
