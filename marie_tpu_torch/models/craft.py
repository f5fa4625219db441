"""CRAFT text detector (port of ``marie_tpu/models/craft.py``).

NHWC at the public interface, NCHW inside.  What must match the flax
model: the space-to-depth stem and depth-to-space head reshape orders
(done in NHWC exactly as flax does them), 'SAME' padding of the 3x3
convs, BatchNorm eps 1e-5, and ``jax.image.resize`` bilinear.  The U-Net
resize only ever upsamples, where JAX's antialiasing has no effect, so it
maps to ``F.interpolate(mode="bilinear", align_corners=False,
antialias=False)``.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from marie_tpu_torch.models.configs import CraftConfig

BN_EPS = 1e-5


class ConvBNRelu(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int = 3):
        super().__init__()
        self.Conv_0 = nn.Conv2d(cin, cout, kernel, padding=kernel // 2)
        self.BatchNorm_0 = nn.BatchNorm2d(cout, eps=BN_EPS)

    def forward(self, x):
        return F.relu(self.BatchNorm_0(self.Conv_0(x)))


class VGGStage(nn.Module):
    def __init__(self, cin: int, features: int, num_convs: int):
        super().__init__()
        self.num_convs = num_convs
        for i in range(num_convs):
            self.add_module(f"ConvBNRelu_{i}",
                            ConvBNRelu(cin if i == 0 else features, features))

    def forward(self, x):
        for i in range(self.num_convs):
            x = getattr(self, f"ConvBNRelu_{i}")(x)
        return x


def resize_bilinear(x: torch.Tensor, hw) -> torch.Tensor:
    """``jax.image.resize(..., "bilinear")`` for an NCHW upsample."""
    return F.interpolate(x, size=tuple(hw), mode="bilinear",
                         align_corners=False, antialias=False)


class UpBlock(nn.Module):
    """Upsample to the skip's size, concat [x, skip], 1x1 then 3x3 conv."""

    def __init__(self, cin: int, cskip: int, mid: int, out: int):
        super().__init__()
        self.ConvBNRelu_0 = ConvBNRelu(cin + cskip, mid, kernel=1)
        self.ConvBNRelu_1 = ConvBNRelu(mid, out, kernel=3)

    def forward(self, x, skip):
        x = resize_bilinear(x, skip.shape[-2:])
        x = torch.cat([x, skip], dim=1)
        return self.ConvBNRelu_1(self.ConvBNRelu_0(x))


class CRAFT(nn.Module):
    """[B, H, W, C] float in [0, 1] -> [B, H/2, W/2, 2] (region, affinity)
    on the stride-``cfg.out_stride`` grid."""

    def __init__(self, cfg: CraftConfig, in_channels: int = 3):
        super().__init__()
        self.cfg = cfg
        c, f = cfg.base_channels, cfg.stem_stride
        self.stage1 = VGGStage(in_channels * f * f, c, 2)
        self.stage2 = VGGStage(c, 2 * c, 2)
        self.stage3 = VGGStage(2 * c, 4 * c, 3)
        self.stage4 = VGGStage(4 * c, 8 * c, 3)
        self.stage5 = VGGStage(8 * c, 8 * c, 3)
        self.up1 = UpBlock(8 * c, 8 * c, 8 * c, 4 * c)
        self.up2 = UpBlock(4 * c, 4 * c, 4 * c, 2 * c)
        self.up3 = UpBlock(2 * c, 2 * c, 2 * c, c)
        self.head1 = ConvBNRelu(c, c)
        self.head2 = ConvBNRelu(c, c // 2 or 1)
        nc = cfg.num_classes
        self.head_out = nn.Conv2d(c // 2 or 1, nc * f * f if cfg.head_d2s else nc, 1)
        self.eval()

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        f = self.cfg.stem_stride
        if f > 1:
            b, h, w, ch = images.shape
            images = images.reshape(b, h // f, f, w // f, f, ch)
            images = images.permute(0, 1, 3, 2, 4, 5).reshape(
                b, h // f, w // f, f * f * ch)
        x = images.permute(0, 3, 1, 2)
        s1 = self.stage1(x)
        s2 = self.stage2(F.max_pool2d(s1, 2, 2))
        s3 = self.stage3(F.max_pool2d(s2, 2, 2))
        s4 = self.stage4(F.max_pool2d(s3, 2, 2))
        s5 = self.stage5(F.max_pool2d(s4, 2, 2))
        u = self.up1(s5, s4)
        u = self.up2(u, s3)
        u = self.up3(u, s2)
        out = self.head_out(self.head2(self.head1(u))).permute(0, 2, 3, 1)
        if self.cfg.head_d2s:
            nc = self.cfg.num_classes
            b, hh, ww, _ = out.shape
            out = out.reshape(b, hh, ww, f, f, nc).permute(0, 1, 3, 2, 4, 5)
            out = out.reshape(b, f * hh, f * ww, nc)
        return torch.sigmoid(out)
