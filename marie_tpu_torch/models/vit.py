"""ViT encoder (port of ``marie_tpu/models/vit.py``): NHWC images at the
public interface, rectangular patches, learned position embeddings;
:meth:`ViTEncoder.feature_grid` is the backbone of the DiT detector
(:class:`DiTDetector`, the model of ``marie_tpu/boxes/dit_box_processor.py``).

The detector head's depth-to-space follows the JAX reshape on NHWC
(:func:`~marie_tpu_torch.models.craft.depth_to_space`), which is not
``F.pixel_shuffle``'s channel order.  Its x2 upsample is
``jax.image.resize`` bilinear
(:func:`~marie_tpu_torch.models.craft.resize_bilinear`; XLA's CPU rounds
its two contractions in a shape-dependent way, so the two agree to one
float32 ulp, not to the bit)."""

import torch
import torch.nn as nn
import torch.nn.functional as F

from marie_tpu_torch.models.configs import ViTConfig
from marie_tpu_torch.models.craft import depth_to_space, resize_bilinear
from marie_tpu_torch.models.layers import EncoderLayer, layer_norm, named_layers


class PatchEmbed(nn.Module):
    def __init__(self, channels: int, patch_hw, hidden_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(channels, hidden_dim, kernel_size=patch_hw,
                              stride=patch_hw)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """[B, H, W, C] -> [B, H/ph * W/pw, D] (row-major patch order)."""
        x = self.proj(images.permute(0, 3, 1, 2))  # [B, D, h, w]
        return x.flatten(2).transpose(1, 2)


class ViTEncoder(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = PatchEmbed(cfg.channels, cfg.patch_hw, cfg.hidden_dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.seq_len, cfg.hidden_dim))
        if cfg.use_cls_token:
            self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.hidden_dim))
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", EncoderLayer(
                cfg.num_heads, cfg.hidden_dim, cfg.mlp_dim))
        self.ln_f = layer_norm(cfg.hidden_dim)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """[B, H, W, C] -> [B, S, D] encoder states."""
        x = self.patch_embed(images)
        if self.cfg.use_cls_token:
            cls = self.cls_token.to(x.dtype).expand(x.shape[0], 1, x.shape[-1])
            x = torch.cat([cls, x], dim=1)
        x = x + self.pos_embed.to(x.dtype)
        for layer in named_layers(self, self.cfg.num_layers):
            x = layer(x)
        return self.ln_f(x)

    def feature_grid(self, images: torch.Tensor) -> torch.Tensor:
        """[B, H, W, C] -> [B, H/ph, W/pw, D] spatial features (the
        detector's use; the CLS token, if any, dropped)."""
        x = self(images)
        c = self.cfg
        if c.use_cls_token:
            x = x[:, 1:]
        ph, pw = c.patch_hw
        return x.reshape(x.shape[0], c.image_size[0] // ph, c.image_size[1] // pw, x.shape[-1])


def upsample_stages(cfg: ViTConfig) -> int:
    """The number of x2 upsample stages from the patch grid to
    ``head_stride * subpixel``."""
    n, s = 0, cfg.patch_hw[0]
    while s > cfg.head_stride * cfg.subpixel:
        s //= 2
        n += 1
    return n


class DiTDetector(nn.Module):
    """[B, H, W, 3] float in [0, 1] -> [B, H/head_stride, W/head_stride, 2]
    sigmoid maps (region, affinity): the ViT feature grid, ``n`` bilinear
    x2 upsamples each followed by a 3x3 conv and ReLU (channels halving,
    at least 32), a 1x1 head and the sub-pixel depth-to-space."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = ViTEncoder(cfg)
        self.n_up = upsample_stages(cfg)
        cin = cfg.hidden_dim
        for i in range(self.n_up):
            ch = max(cfg.hidden_dim >> (i + 1), 32)
            self.add_module(f"up{i}", nn.Conv2d(cin, ch, 3, padding=1))
            cin = ch
        sub = cfg.subpixel
        self.head = nn.Conv2d(cin, 2 * sub * sub, 1)
        self.eval()

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self.backbone.feature_grid(images).permute(0, 3, 1, 2)
        for i in range(self.n_up):
            x = resize_bilinear(x, (2 * x.shape[2], 2 * x.shape[3]))
            x = F.relu(getattr(self, f"up{i}")(x))
        out = depth_to_space(self.head(x).permute(0, 2, 3, 1), self.cfg.subpixel, 2)
        return torch.sigmoid(out)
