"""Learned reading order (port of ``marie_tpu/models/reading_order.py``).

A page's word boxes are ranked in one transformer-encoder forward over
their geometry: every box gets a scalar score, and the reading order is
the stable argsort of the scores.  The model is an ``embed`` Dense over
eight box features, ``num_layers`` :class:`EncoderLayer`s whose
attention masks the padded rows past the page's box count (``kv_len``),
a final LayerNorm and a Dense ``head`` of width 1.  The attention runs
through K2 (:func:`marie_tpu_torch.ops.kernels.flash_attention.
flash_attention`): at the base width, float32 at D=32.

:class:`TextLayout` pads a page to ``max_boxes`` and calls the model at
B=1; a page with more boxes is cut into bands of ``max_boxes`` by a
stable argsort on the boxes' top edge, and each band is ordered alone, as
the JAX class does.  The matmuls run in full float32 (TF32 off) and the
kernel launches count on the ``"reading_order"`` path.
"""

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.profiler import record_function

from marie_tpu_torch.models.layers import EncoderLayer, layer_norm, named_layers
from marie_tpu_torch.ops.kernels._build import launch_path
from marie_tpu_torch.utils.device import float32_precision, resolve_device


@dataclasses.dataclass(frozen=True)
class ReadingOrderConfig:
    hidden_dim: int = 128
    num_layers: int = 4
    num_heads: int = 4
    mlp_dim: int = 256
    max_boxes: int = 256  # the sequence bucket; longer pages are cut into bands

    @staticmethod
    def base() -> "ReadingOrderConfig":
        return ReadingOrderConfig()

    @staticmethod
    def tiny() -> "ReadingOrderConfig":
        return ReadingOrderConfig(hidden_dim=32, num_layers=2, num_heads=2, mlp_dim=64)


def box_features(boxes: torch.Tensor) -> torch.Tensor:
    """xyxy boxes in [0, 1] ``[..., 4]`` -> ``[..., 8]``: x0, y0, x1, y1,
    cx, cy, w, h."""
    x0, y0, x1, y1 = boxes.unbind(-1)
    return torch.stack([x0, y0, x1, y1, (x0 + x1) * 0.5, (y0 + y1) * 0.5, x1 - x0, y1 - y0],
                       dim=-1)


class ReadingOrderModel(nn.Module):
    """Box geometry ``[B, N, 4]`` (+ valid counts ``[B]``) -> scores
    ``[B, N]``; lower reads earlier.  Rows past a page's count are masked
    out of attention and their scores mean nothing."""

    def __init__(self, cfg: ReadingOrderConfig):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Linear(8, cfg.hidden_dim)
        for i in range(cfg.num_layers):
            setattr(self, f"layer_{i}",
                    EncoderLayer(cfg.num_heads, cfg.hidden_dim, cfg.mlp_dim))
        self.ln_f = layer_norm(cfg.hidden_dim)
        self.head = nn.Linear(cfg.hidden_dim, 1)

    def forward(self, boxes: torch.Tensor, n_valid: Optional[torch.Tensor] = None):
        x = self.embed(box_features(boxes))
        for layer in named_layers(self, self.cfg.num_layers):
            x = layer(x, kv_len=n_valid)
        return self.head(self.ln_f(x))[..., 0]


class TextLayout:
    """The JAX ``TextLayout``: ``forward(words, boxes) -> order``,
    ``order(boxes, scale)``, ``reconstruct`` / ``__call__``.  Boxes are
    xyxy in ``[0, scale]`` (LayoutLM's 0..1000 by default); ``words`` are
    taken for the interface and not used, the order is geometry only.

    ``params`` is a flax-layout numpy tree (:mod:`marie_tpu_torch.registry.
    convert`); without one the weights are drawn from
    ``init_flax_layout(config, seed)`` (the JAX class draws its default
    from ``jax.random.PRNGKey(0)``, which the port cannot repeat).  Runs on
    ``device``, the card unless the caller asks for the CPU."""

    def __init__(self, config: Optional[ReadingOrderConfig] = None, params=None, *,
                 seed: int = 0, device="cuda"):
        from marie_tpu_torch.registry.convert import init_flax_layout, load_model

        self.cfg = config or ReadingOrderConfig.base()
        self.device = resolve_device(device)
        if params is None:
            params = init_flax_layout(self.cfg, seed)
        self.model = load_model(self.cfg, params, self.device)

    def __call__(self, *args, **kwargs):
        return self.reconstruct(*args, **kwargs)

    def forward(self, words: Sequence[str], boxes: Sequence[Sequence[float]]) -> List[int]:
        assert len(words) == len(boxes)
        return self.order(boxes)

    def order(self, boxes: Sequence[Sequence[float]], scale: float = 1000.0) -> List[int]:
        """xyxy boxes in ``[0, scale]`` -> the reading order (indices)."""
        return self.order_and_scores(boxes, scale)[0]

    @torch.no_grad()
    def order_and_scores(self, boxes: Sequence[Sequence[float]],
                         scale: float = 1000.0) -> Tuple[List[int], np.ndarray]:
        """(order, scores): the reading order and each box's float32 score
        within its band (scores of two bands are not comparable)."""
        n = len(boxes)
        scores = np.zeros((n,), np.float32)
        if n == 0:
            return [], scores
        arr = np.asarray(boxes, np.float32) / np.float32(scale)
        nb = self.cfg.max_boxes
        if n <= nb:
            bands = [np.arange(n)]
        else:
            pre = np.argsort(arr[:, 1], kind="stable")
            bands = [pre[s:s + nb] for s in range(0, n, nb)]
        out: List[int] = []
        for idx in bands:
            k = len(idx)
            padded = np.zeros((1, nb, 4), np.float32)
            padded[0, :k] = arr[idx]
            with record_function("marie.reading_order"), launch_path("reading_order"), \
                    float32_precision(False):
                got = self.model(torch.from_numpy(padded).to(self.device),
                                 torch.tensor([k], dtype=torch.int32, device=self.device))
            band = got[0, :k].cpu().numpy()
            scores[idx] = band
            out.extend(int(idx[i]) for i in np.argsort(band, kind="stable"))
        return out, scores

    def reconstruct(self, words: Sequence[str], boxes: Sequence[Sequence[float]]):
        """(words, boxes) in reading order."""
        order = self.forward(words, boxes)
        return [words[i] for i in order], [boxes[i] for i in order]
