"""ViT encoder (port of ``marie_tpu/models/vit.py``): NHWC images at the
public interface, rectangular patches, learned position embeddings."""

import torch
import torch.nn as nn

from marie_tpu_torch.models.configs import ViTConfig
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
