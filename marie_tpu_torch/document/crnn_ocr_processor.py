"""CRNN/CTC recogniser processor (port of
``marie_tpu/document/crnn_ocr_processor.py``): word boxes on a page that
is already on the device are cropped there to 32x256 (K1 on a grayscale
page, stock ops on an RGB one), averaged to one channel, run through the
CRNN and collapsed by greedy CTC on the device; host fragments are
converted to grayscale and resized to height 32 with cv2's uint8
arithmetic (:func:`rgb2gray_u8`, :func:`resize_linear_u8`), grouped into
width buckets (64/128/256) and decoded in chunks padded white to a few
fixed batch sizes.  The CRNN runs in float32 with TF32 off, as the JAX
reference computes it.
"""

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from marie_tpu_torch.document.ocr_processor import OcrProcessor
from marie_tpu_torch.models.configs import CRNNConfig
from marie_tpu_torch.models.tokenizer import CTCCharTokenizer
from marie_tpu_torch.ops.ctc import ctc_greedy_decode
from marie_tpu_torch.ops.kernels.crop_resize import crop_resize
from marie_tpu_torch.preprocess.buckets import group_by_bucket, pad_batch
from marie_tpu_torch.preprocess.ops import crop_resize_pages
from marie_tpu_torch.preprocess.resize import resize_linear_u8, rgb2gray_u8
from marie_tpu_torch.registry.convert import init_flax_layout, load_model
from marie_tpu_torch.utils.device import float32_precision, resolve_device


def gray_crops(page_u8: torch.Tensor, boxes_xyxy: torch.Tensor,
               out_h: int, out_w: int) -> torch.Tensor:
    """[N, out_h, out_w, 1] float32 crops of every box on the device page
    [H, W] (K1) or [H, W, 3] (stock ops): the channel mean the JAX
    processor takes of its crops, to the bit (``channel_mean`` of
    :func:`crop_resize`).  The JAX engine uploads three channels even for
    a grayscale page, and XLA's rounding of that mean is not the one
    channel's value for about a third of the pixels."""
    page_of = torch.zeros(boxes_xyxy.shape[0], dtype=torch.int32, device=page_u8.device)
    crop = crop_resize if page_u8.ndim == 2 else crop_resize_pages
    return crop(page_u8[None], page_of, boxes_xyxy, out_h, out_w, channel_mean=True)[0][..., None]


@torch.no_grad()
def _crop_and_ctc(model, page_u8: torch.Tensor, boxes_xyxy: torch.Tensor,
                  out_h: int, out_w: int):
    """Crops of every box on the device page -> CRNN -> greedy CTC:
    (tokens [N, out_w / 4] int32, lengths [N] int32, confidence [N])."""
    with record_function("marie.crop"):
        gray = gray_crops(page_u8, boxes_xyxy, out_h, out_w)
    with record_function("marie.crnn"), float32_precision(allow_tf32=False):
        return ctc_greedy_decode(model(gray), blank_id=0)


class CrnnOcrProcessor(OcrProcessor):
    """CRNN/CTC over word boxes of device pages and over host fragments
    (the JAX package's ``CrnnOcrProcessor``).  ``variables`` is a
    flax-layout numpy tree; without one the weights are drawn from seed
    2.  Port-only keyword: ``device``."""

    #: the zoo tree the weights came from (None: passed in or seeded)
    zoo_name: Optional[str] = None

    def __init__(
        self,
        config: Optional[CRNNConfig] = None,
        variables=None,
        tokenizer: Optional[CTCCharTokenizer] = None,
        width_buckets: Sequence[int] = (64, 128, 256),
        batch_sizes: Sequence[int] = (8, 32, 128),
        *,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.config = config or CRNNConfig()
        self.tokenizer = tokenizer or CTCCharTokenizer()
        self.width_buckets = tuple(width_buckets)
        self.batch_sizes = tuple(batch_sizes)
        self.crop_h = self.config.input_height
        if variables is None:
            variables = init_flax_layout(self.config, 2)
        self.model = load_model(self.config, variables, self.device, torch.float32)

    def recognize_from_page(self, page_dev: torch.Tensor, boxes_xywh: np.ndarray,
                            scale: float = 1.0) -> List[Dict[str, Any]]:
        return self.recognize_collect(self.recognize_dispatch(page_dev, boxes_xywh, scale))

    def recognize_dispatch(self, page_dev: torch.Tensor, boxes_xywh, scale: float = 1.0):
        """Launch crop + CRNN + CTC for all chunks of ``boxes_xywh``
        (original page coordinates; ``scale`` maps them onto the device
        page), each of at most ``batch_sizes[-1]`` boxes padded to a
        configured batch size with dummy 1x1 boxes; crops are
        ``width_buckets[-1]`` wide."""
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
            padded = np.zeros((pad_batch(len(chunk), self.batch_sizes), 4), np.float32)
            padded[:, 2:] = 1.0  # dummy 1x1 boxes for pad rows
            padded[: len(chunk)] = chunk
            out = _crop_and_ctc(self.model, page_dev,
                                torch.from_numpy(padded).to(page_dev.device),
                                self.crop_h, self.width_buckets[-1])
            futures.append((len(chunk), *out))
        return futures

    def recognize_collect(self, futures) -> List[Dict[str, Any]]:
        return self.recognize_collect_many([futures])[0]

    def recognize_collect_many(self, futures_lists) -> List[List[Dict[str, Any]]]:
        """Collect many pages' dispatched chunks with one device-to-host
        copy: each chunk's tokens and confidence bits go into one int32
        array on the device first.  Tokens past a row's length are -1,
        which decoding drops."""
        flat = [f for fl in futures_lists for f in fl]
        if not flat:
            return [[] for _ in futures_lists]
        packed = torch.cat([
            torch.cat([tok, conf.view(torch.int32)[:, None]], dim=1)
            for _, tok, _, conf in flat
        ]).cpu().numpy()
        texts = self.tokenizer.decode_batch(packed[:, :-1])
        conf = np.ascontiguousarray(packed[:, -1]).view(np.float32)

        out_all: List[List[Dict[str, Any]]] = []
        row = 0
        for fl in futures_lists:
            page_out: List[Dict[str, Any]] = []
            for n_chunk, tok_dev, _, _ in fl:
                for r in range(n_chunk):
                    page_out.append({"text": texts[row + r], "confidence": float(conf[row + r])})
                row += tok_dev.shape[0]
            out_all.append(page_out)
        return out_all

    def _prep(self, frag: np.ndarray) -> np.ndarray:
        """uint8 fragment -> float32 [32, w <= width_buckets[-1]]."""
        if frag.dtype != np.uint8:
            raise ValueError(f"fragments are uint8, got {frag.dtype}")
        if frag.ndim == 3:
            frag = rgb2gray_u8(frag)
        fh, fw = frag.shape[:2]
        if fh == 0 or fw == 0:
            return np.full((self.crop_h, 1), 1.0, np.float32)
        scale = self.crop_h / fh
        new_w = max(1, min(int(round(fw * scale)), self.width_buckets[-1]))
        out = resize_linear_u8(frag, (new_w, self.crop_h)).astype(np.float32)
        if out.max() > 1.5:
            out = out / 255.0
        return out

    @torch.no_grad()
    def recognize_from_fragments(self, fragments: Sequence[np.ndarray]) -> List[Dict[str, Any]]:
        """Host fragments (uint8 [h, w] or [h, w, 3] cut-outs) -> one word
        dict each: grayscale, resized to height 32 (aspect kept, at most
        the largest width bucket), grouped by width bucket (the tensor is
        the bucket's width), chunked and padded white."""
        n = len(fragments)
        if n == 0:
            return []
        preps = [self._prep(f) for f in fragments]
        groups = group_by_bucket([p.shape[1] for p in preps], self.width_buckets)
        out: List[Any] = [None] * n  # every index is in one width group
        max_bs = self.batch_sizes[-1]
        for bucket_w, indices in groups.items():
            for start in range(0, len(indices), max_bs):
                chunk = indices[start: start + max_bs]
                batch = np.full((pad_batch(len(chunk), self.batch_sizes), self.crop_h,
                                 bucket_w, 1), 1.0, np.float32)
                for row, idx in enumerate(chunk):
                    batch[row, :, : preps[idx].shape[1], 0] = preps[idx]
                with float32_precision(allow_tf32=False):
                    tokens, _, conf = ctc_greedy_decode(
                        self.model(torch.from_numpy(batch).to(self.device)), blank_id=0)
                texts = self.tokenizer.decode_batch(tokens.cpu().numpy())
                conf = conf.cpu().numpy()
                for row, idx in enumerate(chunk):
                    out[idx] = {"text": texts[row], "confidence": float(conf[row])}
        return out
