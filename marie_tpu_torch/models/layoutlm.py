"""LayoutLMv3-style document encoder with classification and
token-classification heads (port of ``marie_tpu/models/layoutlm.py``).

Inputs are word tokens with their layout boxes in coordinate buckets
(and an optional NHWC page image); sequences are padded to a fixed
length with a ``seq_len`` mask, which every encoder layer hands to the
fused attention kernel (K2) as ``kv_len``.  Long pages go through a
static stack of sliding windows (:func:`sliding_windows`) whose logits
are overlap-averaged back (:func:`merge_window_logits`).

Module names follow the flax modules (``embeddings.word``, ``norm``,
``layer_i``, ``ln_f``, ``head.layers_0`` ...) for the weight bridge.
"""

from typing import Optional, Tuple

import torch
import torch.nn as nn

from marie_tpu_torch.models.configs import LayoutLMConfig
from marie_tpu_torch.models.layers import EncoderLayer, layer_norm, named_layers
from marie_tpu_torch.models.vit import PatchEmbed


class LayoutEmbeddings(nn.Module):
    """Word + 1D-position + 2D-layout embeddings; boxes are xyxy in
    [0, max_2d_pos), and width and height get their own tables."""

    def __init__(self, cfg: LayoutLMConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_dim
        self.word = nn.Embedding(cfg.vocab_size, d)
        self.pos = nn.Embedding(cfg.max_seq_len, d)
        for name in ("x0", "y0", "x1", "y1", "w", "h"):
            setattr(self, name, nn.Embedding(cfg.max_2d_pos, d))

    def forward(self, tokens: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        top = self.cfg.max_2d_pos - 1
        x = self.word(tokens.long())
        x = x + self.pos(torch.arange(tokens.shape[1], device=tokens.device))[None]
        bx = torch.clamp(boxes.long(), 0, top)
        w = torch.clamp(bx[..., 2] - bx[..., 0], 0, top)
        h = torch.clamp(bx[..., 3] - bx[..., 1], 0, top)
        return (x + self.x0(bx[..., 0]) + self.y0(bx[..., 1]) + self.x1(bx[..., 2])
                + self.y1(bx[..., 3]) + self.w(w) + self.h(h))


class LayoutLMv3Encoder(nn.Module):
    """Text (+layout) and optional image tokens through one transformer."""

    def __init__(self, cfg: LayoutLMConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = LayoutEmbeddings(cfg)
        if cfg.use_image:
            self.patch_embed = PatchEmbed(3, (cfg.patch_size, cfg.patch_size), cfg.hidden_dim)
            self.vis_pos = nn.Parameter(torch.zeros(1, cfg.n_patches, cfg.hidden_dim))
        self.norm = layer_norm(cfg.hidden_dim)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", EncoderLayer(cfg.num_heads, cfg.hidden_dim,
                                                       cfg.mlp_dim))
        self.ln_f = layer_norm(cfg.hidden_dim)

    def forward(self, tokens: torch.Tensor, boxes: torch.Tensor,
                seq_len: Optional[torch.Tensor] = None,
                image: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens [B, L], boxes [B, L, 4], seq_len [B] valid text tokens,
        image [B, H, W, 3] -> [B, L (+ patches), D], text tokens first.

        With an image and ``seq_len``, the always-valid visual tokens go
        in front, so one ``kv_len = seq_len + patches`` masks the text
        padding; the order is restored after ``ln_f``."""
        x = self.norm(self.embeddings(tokens, boxes))
        kv_len, n_front = seq_len, 0
        if self.cfg.use_image and image is not None:
            vis = self.patch_embed(image) + self.vis_pos.to(x.dtype)
            if seq_len is not None:
                n_front = vis.shape[1]
                x = torch.cat([vis, x], dim=1)
                kv_len = seq_len + n_front
            else:
                x = torch.cat([x, vis], dim=1)
        for layer in named_layers(self, self.cfg.num_layers):
            x = layer(x, kv_len=kv_len)
        x = self.ln_f(x)
        if n_front:
            x = torch.cat([x[:, n_front:], x[:, :n_front]], dim=1)
        return x


class _ClassifierHead(nn.Module):
    """flax ``nn.Sequential([Dense(D), tanh, Dense(labels)])``: its Dense
    layers are ``layers_0`` and ``layers_2``."""

    def __init__(self, dim: int, num_labels: int):
        super().__init__()
        self.layers_0 = nn.Linear(dim, dim)
        self.layers_2 = nn.Linear(dim, num_labels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers_2(torch.tanh(self.layers_0(x)))


class LayoutLMv3ForSequenceClassification(nn.Module):
    """Page classifier: mean of the valid text tokens -> logits [B, labels]."""

    def __init__(self, cfg: LayoutLMConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = LayoutLMv3Encoder(cfg)
        self.head = _ClassifierHead(cfg.hidden_dim, cfg.num_labels)

    def forward(self, tokens, boxes, seq_len=None, image=None) -> torch.Tensor:
        x = self.encoder(tokens, boxes, seq_len, image)
        l_text = tokens.shape[1]
        text = x[:, :l_text]
        if seq_len is None:
            pooled = text.mean(1)
        else:
            mask = (torch.arange(l_text, device=x.device)[None, :]
                    < seq_len[:, None])[..., None]
            pooled = (text * mask).sum(1) / torch.clamp(mask.sum(1), min=1)
        return self.head(pooled)


class LayoutLMv3ForTokenClassification(nn.Module):
    """NER / key-value head: logits [B, L, labels] for the text tokens."""

    def __init__(self, cfg: LayoutLMConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = LayoutLMv3Encoder(cfg)
        self.head = nn.Linear(cfg.hidden_dim, cfg.num_labels)

    def forward(self, tokens, boxes, seq_len=None, image=None) -> torch.Tensor:
        x = self.encoder(tokens, boxes, seq_len, image)
        return self.head(x[:, :tokens.shape[1]])


def sliding_windows(tokens: torch.Tensor, boxes: torch.Tensor, window: int = 512,
                    stride: int = 128) -> Tuple[torch.Tensor, ...]:
    """[L] tokens and [L, 4] boxes -> a fixed stack of windows starting at
    0, stride, 2*stride ... (the last one ends at L): (tokens [N, W], boxes
    [N, W, 4], starts [N], valid [N, W]); positions past L are 0."""
    l = tokens.shape[0]
    num = 1 if l <= window else 1 + -(-(l - window) // stride)
    dev = tokens.device
    starts = torch.clamp(torch.arange(num, device=dev) * stride, max=max(l - window, 0))
    raw = starts[:, None] + torch.arange(window, device=dev)[None, :]
    valid = raw < l
    idx = torch.clamp(raw, max=l - 1)
    win_tokens = torch.where(valid, tokens[idx], 0)
    win_boxes = torch.where(valid[..., None], boxes[idx], 0)
    return win_tokens, win_boxes, starts, valid


def merge_window_logits(logits: torch.Tensor, starts: torch.Tensor, valid: torch.Tensor,
                        total_len: int) -> torch.Tensor:
    """Overlap-average window logits [N, W, C] back to [total_len, C].
    Positions that are not valid or fall past ``total_len`` are dropped
    (the JAX scatter's ``mode="drop"``).  On CUDA ``index_add_`` adds
    with atomics, in no fixed order: up to ceil(W / stride) windows cover
    a position, so sums differ from the CPU's in the last float32 bits."""
    window, c = logits.shape[1], logits.shape[-1]
    pos = (starts[:, None] + torch.arange(window, device=logits.device)[None, :]).reshape(-1)
    keep = valid.reshape(-1) & (pos < total_len)
    pos = pos[keep]
    out = torch.zeros(total_len, c, dtype=logits.dtype, device=logits.device)
    cnt = torch.zeros(total_len, 1, dtype=logits.dtype, device=logits.device)
    out.index_add_(0, pos, logits.reshape(-1, c)[keep])
    cnt.index_add_(0, pos, torch.ones(pos.shape[0], 1, dtype=logits.dtype,
                                      device=logits.device))
    return out / torch.clamp(cnt, min=1.0)
