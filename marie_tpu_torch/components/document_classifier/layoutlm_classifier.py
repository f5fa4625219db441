"""Document classifier over the LayoutLMv3-style encoder (port of
``marie_tpu/components/document_classifier/layoutlm_classifier.py``):
pages padded to ``max_seq_len`` tokens with a length mask, batches padded
to a few fixed sizes, and with an image branch each page's image resized
to the config's ``image_size`` as cv2 resizes it.  ``from_zoo`` and
``from_zoo_chain`` load the trained heads of ``torch_zoo/``
(:mod:`marie_tpu_torch.registry.zoo`).
"""

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from marie_tpu_torch.components.base import BaseDocumentClassifier, PageInput
from marie_tpu_torch.components.word_tokenizer import HashWordTokenizer, RollingWordTokenizer
from marie_tpu_torch.models.configs import LayoutLMConfig
from marie_tpu_torch.ops.kernels._build import launch_path
from marie_tpu_torch.preprocess.buckets import pad_batch
from marie_tpu_torch.preprocess.resize import resize_linear_u8
from marie_tpu_torch.registry.convert import init_flax_layout, load_model
from marie_tpu_torch.registry.zoo import zoo_params
from marie_tpu_torch.utils.device import float32_precision, resolve_device

SYNTH_CLASS_LABELS = ("invoice", "correspondence", "claim")

def resize_page_image(image: np.ndarray, size_hw: Tuple[int, int],
                      device: torch.device) -> torch.Tensor:
    """``cv2.resize(image, (w, h)).astype(float32) / 255`` as float32 [h,
    w, 3] on ``device`` (the JAX classifier's page image); a 2-D page is
    resized, then stacked to 3 channels.  A uint8 image is resized on the
    host with cv2's fixed-point arithmetic (``resize_linear_u8``, equal
    to cv2 to the bit), uploaded as uint8 and divided by 255 there (a
    true division, as numpy's); other dtypes take torch's float bilinear
    (cv2's float path: half-pixel centres, no antialias), within float
    rounding of cv2."""
    if image.dtype == np.uint8:
        small = resize_linear_u8(np.ascontiguousarray(image), (size_hw[1], size_hw[0]))
        y = torch.from_numpy(small).to(device).to(torch.float32)
    else:
        x = torch.from_numpy(np.ascontiguousarray(image, dtype=np.float32)).to(device)
        x = x[None, None] if x.ndim == 2 else x.permute(2, 0, 1)[None]
        y = F.interpolate(x, size=tuple(size_hw), mode="bilinear", align_corners=False,
                          antialias=False)
        y = y[0, 0] if image.ndim == 2 else y[0].permute(1, 2, 0)
    # a 0-dim device tensor: torch multiplies by the reciprocal of a CPU
    # scalar on the card, which is not always the quotient
    y = y / torch.tensor(255.0, device=device)
    return y[..., None].expand(*y.shape, 3) if image.ndim == 2 else y


class LayoutDocumentClassifier(BaseDocumentClassifier):
    """Page classification -> per page {"label", "score", "scores"}.
    ``params`` is a flax-layout numpy tree; without one the weights are
    drawn from seed 0.  Port-only keyword: ``device``."""

    #: the zoo tree the weights came from (None: passed in or seeded)
    zoo_name: Optional[str] = None

    @classmethod
    def from_zoo(cls, name: str = "layout-classifier-synth", labels=SYNTH_CLASS_LABELS,
                 *, device="cuda") -> "Optional[LayoutDocumentClassifier]":
        """The zoo's synthetic-trained classifier, or None when absent."""
        params = zoo_params(name)
        if params is None:
            return None
        head = cls(labels=labels, config=LayoutLMConfig.synth(num_labels=len(labels)),
                   params=params, device=device)
        head.zoo_name = name
        return head

    @classmethod
    def from_zoo_chain(cls, name: str = "layout-classifier-chain", labels=SYNTH_CLASS_LABELS,
                       *, device="cuda") -> "Optional[LayoutDocumentClassifier]":
        """The head trained for the fused chain (``RollingWordTokenizer``
        ids, sequence cap 192), or None when absent."""
        params = zoo_params(name)
        if params is None:
            return None
        config = dataclasses.replace(LayoutLMConfig.synth(num_labels=len(labels)),
                                     max_seq_len=192)
        head = cls(labels=labels, config=config, params=params,
                   tokenizer=RollingWordTokenizer(config.vocab_size), device=device)
        head.zoo_name = name
        return head

    def __init__(
        self,
        labels: Sequence[str] = ("negative", "positive"),
        config: Optional[LayoutLMConfig] = None,
        params=None,
        tokenizer: Optional[HashWordTokenizer] = None,
        batch_sizes: Sequence[int] = (4, 8, 16, 32),
        *,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.labels = list(labels)
        self.config = config or LayoutLMConfig.base(num_labels=len(self.labels))
        if self.config.num_labels != len(self.labels):
            raise ValueError("config.num_labels must match labels")
        self.tokenizer = tokenizer or HashWordTokenizer(self.config.vocab_size)
        self.batch_sizes = tuple(batch_sizes)
        self.use_image = self.config.use_image
        if params is None:
            params = init_flax_layout(self.config, 0, "sequence")
        self.model = load_model(self.config, params, self.device, head="sequence")

    def _encode_batch(self, pages: Sequence[PageInput]):
        """(tokens [bs, L], boxes [bs, L, 4], seq_len [bs], images [bs, H,
        W, 3] or None) on the device; ``bs`` is the padded batch size and
        pages without an image get a white one."""
        l = self.config.max_seq_len
        bs = pad_batch(len(pages), self.batch_sizes)
        tokens = np.zeros((bs, l), np.int32)
        boxes = np.zeros((bs, l, 4), np.int32)
        seq_len = np.ones((bs,), np.int32)
        for i, page in enumerate(pages):
            t, b, n = self.tokenizer.encode_page(
                page.words, page.boxes, page.page_size, l, self.config.max_2d_pos)
            tokens[i], boxes[i], seq_len[i] = t, b, max(n, 1)
        images = None
        if self.use_image:
            ih, iw = self.config.image_size
            images = torch.ones((bs, ih, iw, 3), dtype=torch.float32, device=self.device)
            for i, page in enumerate(pages):
                if page.image is not None:
                    images[i] = resize_page_image(page.image, (ih, iw), self.device)
        dev = self.device
        return (torch.from_numpy(tokens).to(dev), torch.from_numpy(boxes).to(dev),
                torch.from_numpy(seq_len).to(dev), images)

    @torch.no_grad()
    def logits(self, pages: Sequence[PageInput]) -> torch.Tensor:
        """[len(pages), labels] float32 logits on the device."""
        tokens, boxes, seq_len, images = self._encode_batch(pages)
        with record_function("marie.heads"), launch_path("heads"), float32_precision(False):
            return self.model(tokens, boxes, seq_len, images)[:len(pages)]

    def predict(self, pages: Sequence[PageInput]) -> List[Dict[str, Any]]:
        if not pages:
            return []
        probs = torch.softmax(self.logits(pages), dim=-1).cpu().numpy()
        out = []
        for row in probs:
            idx = int(np.argmax(row))
            out.append({
                "label": self.labels[idx],
                "score": float(row[idx]),
                "scores": {lb: float(p) for lb, p in zip(self.labels, row)},
            })
        return out
