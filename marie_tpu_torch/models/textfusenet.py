"""TextFuseNet (port of ``marie_tpu/models/textfusenet.py``): a conv FPN
backbone with three dense branches at stride 4 (word region + affinity,
character centres, a global text segmentation whose pre-logit features
are the global context), and a fuse module that refines each word
candidate from its ROI features, the mean ROI features of the characters
it contains (inter / char area > ``contain_thresh``) and the ROI-pooled
global context.

NHWC at the public interface, NCHW inside; module names are the flax
ones, so the weight bridge maps the trained trees by name.  The sub-pixel
head's depth-to-space is the JAX reshape on NHWC
(:func:`~marie_tpu_torch.models.craft.depth_to_space`); GroupNorm is
flax's (:class:`~marie_tpu_torch.models.pix2pix.GroupNorm`).
"""

from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from marie_tpu_torch.models.configs import TextFuseNetConfig
from marie_tpu_torch.models.craft import (
    ConvBNRelu,
    VGGStage,
    depth_to_space,
    resize_bilinear,
)
from marie_tpu_torch.models.pix2pix import GroupNorm
from marie_tpu_torch.ops.roi_align import roi_align_single

__all__ = ["TextFuseNet", "TextFuseNetConfig"]

def _conv(cin: int, cout: int, k: int, bias: bool = True) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, padding=k // 2, bias=bias)


class _FPN(nn.Module):
    """3-level conv backbone + top-down FPN -> (P3 /4, P4 /8, P5 /16)."""

    def __init__(self, cfg: TextFuseNetConfig):
        super().__init__()
        w2, w3, w4 = cfg.backbone_widths
        c = cfg.channels
        self.ConvBNRelu_0 = ConvBNRelu(3, w2)
        self.VGGStage_0 = VGGStage(w2, w2, 2)
        self.VGGStage_1 = VGGStage(w2, w3, 2)
        self.VGGStage_2 = VGGStage(w3, w4, 2)
        self.VGGStage_3 = VGGStage(w4, w4, 2)
        self.lat5 = _conv(w4, c, 1)
        self.lat4 = _conv(w4, c, 1)
        self.lat3 = _conv(w3, c, 1)
        self.smooth3 = _conv(c, c, 3)
        self.smooth4 = _conv(c, c, 3)

    def forward(self, x: torch.Tensor):
        x = F.max_pool2d(self.ConvBNRelu_0(x), 2, 2)
        c2 = self.VGGStage_0(x)                                  # /2
        c3 = self.VGGStage_1(F.max_pool2d(c2, 2, 2))             # /4
        c4 = self.VGGStage_2(F.max_pool2d(c3, 2, 2))             # /8
        c5 = self.VGGStage_3(F.max_pool2d(c4, 2, 2))             # /16
        p5 = self.lat5(c5)
        p4 = self.lat4(c4) + resize_bilinear(p5, c4.shape[-2:])
        p3 = self.lat3(c3) + resize_bilinear(p4, c3.shape[-2:])
        return self.smooth3(p3), self.smooth4(p4), p5


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class TextFuseNet(nn.Module):
    """Dense multi-branch detector with instance-level feature fusion."""

    def __init__(self, cfg: TextFuseNetConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg.channels
        r = 4 // cfg.head_stride
        self.fpn = _FPN(cfg)
        for branch in ("word", "char", "seg"):
            for i in range(2):
                self.add_module(f"{branch}_convs_{i}", ConvBNRelu(c, c))
        self.word_logits = _conv(c, 2 * r * r, 1)
        self.char_logits = _conv(c, r * r, 1)
        for i in range(3):
            self.add_module(f"seg_lat_{i}", _conv(c, c, 1))
        self.seg_logits = _conv(c, 1, 1)
        self.char_c3 = _conv(c, c, 3, bias=False)
        self.char_c1 = _conv(c, c, 1, bias=False)
        self.fuse_c3 = _conv(c, c, 3, bias=False)
        self.fuse_c1 = _conv(c, c, 1, bias=False)
        self.fuse_gn = GroupNorm(c, groups=8)
        self.score_head = nn.Linear(c, 1)
        self.delta_head = nn.Linear(c, 4)
        self.eval()

    def _branch(self, name: str, x: torch.Tensor) -> torch.Tensor:
        for i in range(2):
            x = getattr(self, f"{name}_convs_{i}")(x)
        return x

    def dense(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """[B, H, W, 3] float in [0, 1] -> NHWC maps at ``head_stride``
        (``word`` [B, h, w, 2] and ``char`` [B, h, w, 1] sigmoids) and at
        stride 4 (``seg_logits`` [.., 1], ``seg_feat`` and ``p3`` [.., C])."""
        p3, p4, p5 = self.fpn(images.permute(0, 3, 1, 2))
        r = 4 // self.cfg.head_stride
        word = self.word_logits(self._branch("word", p3))
        word = torch.sigmoid(depth_to_space(_nhwc(word), r, 2))
        char = self.char_logits(self._branch("char", p3))
        char = torch.sigmoid(depth_to_space(_nhwc(char), r, 1))
        hw = p3.shape[-2:]
        seg = self.seg_lat_0(p3)
        seg = seg + resize_bilinear(self.seg_lat_1(p4), hw)
        seg = seg + resize_bilinear(self.seg_lat_2(p5), hw)
        seg = self._branch("seg", seg)
        return {"word": word, "char": char, "seg_logits": _nhwc(self.seg_logits(seg)),
                "seg_feat": _nhwc(seg), "p3": _nhwc(p3)}

    forward = dense

    def fuse(self, p3: torch.Tensor, seg_feat: torch.Tensor, word_boxes: torch.Tensor,
             word_valid: torch.Tensor, char_boxes: torch.Tensor,
             char_valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """One page's [h, w, C] stride-4 features and global context, word
        boxes [K, 4] and char boxes [M, 4] (xyxy, stride-4 grid) with their
        valid flags -> (score [K] in [0, 1], refined boxes [K, 4])."""
        cfg = self.cfg
        dev = p3.device

        def pool_rois(feat_hwc, boxes):
            out = roi_align_single(feat_hwc.permute(2, 0, 1), boxes, output_size=cfg.pool,
                                   device=dev)
            return out  # [K, C, p, p]

        w_feat = pool_rois(p3, word_boxes)
        c_feat = pool_rois(p3, char_boxes)
        g_feat = pool_rois(seg_feat, word_boxes)

        # containment: inter_area / char_area > contain_thresh
        lt = torch.maximum(word_boxes[:, None, :2], char_boxes[None, :, :2])
        rb = torch.minimum(word_boxes[:, None, 2:], char_boxes[None, :, 2:])
        wh = torch.clamp(rb - lt, min=0.0)
        inter = wh[..., 0] * wh[..., 1]  # [K, M]
        char_area = torch.clamp((char_boxes[:, 2] - char_boxes[:, 0])
                                * (char_boxes[:, 3] - char_boxes[:, 1]), min=1e-6)
        contains = (inter / char_area[None, :]) > cfg.contain_thresh
        contains = contains & word_valid[:, None] & char_valid[None, :]

        # masked mean of the contained chars' features; the word's own
        # features where it contains none
        wmask = contains.to(p3.dtype)
        denom = torch.clamp(wmask.sum(-1), min=1.0)
        m = c_feat.shape[0]
        char_mean = (wmask @ c_feat.reshape(m, -1)).reshape(w_feat.shape) \
            / denom[:, None, None, None]
        char_ctx = torch.where(contains.any(-1)[:, None, None, None], char_mean, w_feat)
        char_ctx = self.char_c1(self.char_c3(char_ctx))

        fused = char_ctx + w_feat + g_feat
        fused = F.relu(self.fuse_gn(self.fuse_c1(self.fuse_c3(fused))))
        flat = fused.mean(dim=(2, 3))  # [K, C]
        score = torch.sigmoid(self.score_head(flat)[:, 0])
        deltas = self.delta_head(flat)
        # deltas refine (cx, cy, log w, log h), as Faster R-CNN
        cx = (word_boxes[:, 0] + word_boxes[:, 2]) * 0.5
        cy = (word_boxes[:, 1] + word_boxes[:, 3]) * 0.5
        bw = torch.clamp(word_boxes[:, 2] - word_boxes[:, 0], min=1e-3)
        bh = torch.clamp(word_boxes[:, 3] - word_boxes[:, 1], min=1e-3)
        ncx = cx + deltas[:, 0] * bw
        ncy = cy + deltas[:, 1] * bh
        nw = bw * torch.exp(torch.clamp(deltas[:, 2], -2.0, 2.0))
        nh = bh * torch.exp(torch.clamp(deltas[:, 3], -2.0, 2.0))
        refined = torch.stack([ncx - nw / 2, ncy - nh / 2, ncx + nw / 2, ncy + nh / 2],
                              dim=-1)
        return score, refined
