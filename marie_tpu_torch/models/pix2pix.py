"""pix2pix generator for document overlay cleanup (port of
``marie_tpu/models/pix2pix.py``): c7s1-f, d2f, d4f, R4f x n, u2f, uf,
c7s1-3 + tanh, NHWC at the public interface and NCHW inside.

What must match the flax model:

* flax ``"SAME"`` padding is zero padding, split as XLA splits it: the
  stride-2 3x3 convolutions pad (0, 1) on an even side and (1, 1) on an
  odd one, so the padding is applied with ``F.pad`` and not by the
  (symmetric) ``padding=`` of ``nn.Conv2d``;
* ``nn.ConvTranspose(k=3, s=2, "SAME")`` is a correlation of the
  stride-dilated input, padded (2, 1), with the kernel as stored
  (``transpose_kernel=False``).  ``nn.ConvTranspose2d(padding=0)`` pads
  the dilated input (2, 2) and correlates with the kernel flipped, so it
  is given the flax kernel flipped spatially (``registry/convert.py``)
  and its last row and column are cropped;
* ``nn.GroupNorm(num_groups=None, group_size=1)`` is an instance norm
  with scale and bias, epsilon 1e-6, statistics in float32 as
  ``E[x^2] - E[x]^2`` clipped at 0, and ``(x - mean) * (rsqrt(var + eps)
  * scale) + bias`` in float32, rounded to the input's dtype once;
* on the CPU the last ``tanh`` is XLA's CPU tanh (:func:`xla_tanh`): it
  saturates to exactly +-1 from |x| = 7.9988 on, where the exact tanh
  stays an ulp under 1 up to |x| ~ 9, and a page's white pixels sit
  there (``clip((fake + 1) * 127.5)`` truncates 254.99998 to 254).  Its
  gradient is JAX's, ``1 - y^2`` of the output, not the polynomial's.
  The card runs ``torch.tanh``.

:class:`PatchDiscriminator` is the overlay trainer's PatchGAN
(``marie_tpu/train/overlay.py``): 4x4 ``"SAME"`` convolutions (stride 2
pads (1, 1) on an even side, stride 1 pads (1, 2)), the same GroupNorm,
leaky ReLU 0.2.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from marie_tpu_torch.models.configs import Pix2PixConfig

GN_EPS = 1e-6


_TANH_CLAMP = 7.99881172180175781
_TANH_NUM = (-2.76076847742355e-16, 2.00018790482477e-13, -8.60467152213735e-11,
             5.12229709037114e-08, 1.48572235717979e-05, 6.37261928875436e-04,
             4.89352455891786e-03)
_TANH_DEN = (1.19825839466702e-06, 1.18534705686654e-04, 2.26843463243900e-03,
             4.89352518554385e-03)


def _xla_tanh_forward(x: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    xc = torch.clamp(x32, -_TANH_CLAMP, _TANH_CLAMP)
    x2 = (xc * xc).double()

    def poly(coeffs):
        acc = torch.full_like(x2, float(torch.tensor(coeffs[0], dtype=torch.float32)))
        for c in coeffs[1:]:
            c32 = float(torch.tensor(c, dtype=torch.float32))
            acc = (x2 * acc + c32).float().double()  # an FMA, rounded to float32
        return acc.float()

    y = (xc * poly(_TANH_NUM)) / poly(_TANH_DEN)
    return torch.where(x32.abs() < 0.0004, x32, y).to(x.dtype)


class _XlaTanh(torch.autograd.Function):
    """XLA's CPU tanh forward, JAX's tanh gradient ``g * (1 - y^2)``."""

    @staticmethod
    def forward(ctx, x):
        y = _xla_tanh_forward(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * (1 - y * y)


def xla_tanh(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 tanh (``EmitFastTanh`` with FMA): the input
    clamped to +-7.99881172, a rational polynomial in x^2 by float32
    fused multiply-adds (emulated in float64), one float32 division; x
    itself below 0.0004.  Equal to ``jnp.tanh`` under jit on the CPU on
    2.2 M probed values.  Differentiable, as JAX differentiates ``tanh``:
    ``1 - y^2`` of the output.  A float64 input takes ``torch.tanh`` (the
    polynomial is the float32 one)."""
    if x.dtype == torch.float64:
        return torch.tanh(x)
    return _XlaTanh.apply(x)


def _same_pads(size: int, k: int, s: int):
    """XLA's (low, high) ``"SAME"`` padding of one side."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Conv2d):
    """``nn.Conv(features, (k, k), strides=(s, s), padding="SAME")``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__(cin, cout, k, stride=stride, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel_size[0], self.stride[0]
        top, bottom = _same_pads(x.shape[2], k, s)
        left, right = _same_pads(x.shape[3], k, s)
        return super().forward(F.pad(x, (left, right, top, bottom)))


class SameConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose(features, (3, 3), strides=(2, 2), padding="SAME")``:
    [B, C, H, W] -> [B, C', 2H, 2W]."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 3, stride=2, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x)[:, :, :-1, :-1]


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm`` on NCHW: ``groups`` groups of channels, or one
    channel a group (``groups=None``: flax's ``group_size=1``, an instance
    norm), epsilon 1e-6, statistics in float32 (float64 for float64
    inputs, as flax promotes) as ``E[x^2] - E[x]^2`` clipped at 0, ``(x -
    mean) * (rsqrt(var + eps) * scale) + bias`` in that type, rounded to
    the input's dtype once."""

    #: the bridge names this module's weight ``scale`` in the flax tree
    flax_norm = True

    def __init__(self, features: int, groups=None):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        g = self.groups or c
        ct = torch.promote_types(x.dtype, torch.float32)
        x32 = x.to(ct)
        grouped = x32.reshape(b, g, c // g, h, w)
        mean = grouped.mean(dim=(2, 3, 4), keepdim=True)
        mean2 = (grouped * grouped).mean(dim=(2, 3, 4), keepdim=True)
        var = torch.clamp(mean2 - mean * mean, min=0.0)

        def per_channel(v):
            return v.expand(b, g, c // g, 1, 1).reshape(b, c, 1, 1)

        mul = per_channel(torch.rsqrt(var + GN_EPS)) * self.weight.to(ct)[None, :, None, None]
        y = (x32 - per_channel(mean)) * mul + self.bias.to(ct)[None, :, None, None]
        return y.to(x.dtype)


class ResnetBlock(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.Conv_0 = SameConv2d(features, features, 3)
        self.GroupNorm_0 = GroupNorm(features)
        self.Conv_1 = SameConv2d(features, features, 3)
        self.GroupNorm_1 = GroupNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.GroupNorm_0(self.Conv_0(x)))
        return x + self.GroupNorm_1(self.Conv_1(h))


class ResnetGenerator(nn.Module):
    """[B, H, W, C] in [-1, 1] -> [B, H, W, C] in [-1, 1]; H and W
    multiples of 4 (the overlay pads pages to multiples of 8)."""

    def __init__(self, cfg: Pix2PixConfig):
        super().__init__()
        self.cfg = cfg
        f = cfg.base_channels
        self.Conv_0 = SameConv2d(cfg.in_channels, f, 7)
        self.GroupNorm_0 = GroupNorm(f)
        self.Conv_1 = SameConv2d(f, 2 * f, 3, 2)
        self.GroupNorm_1 = GroupNorm(2 * f)
        self.Conv_2 = SameConv2d(2 * f, 4 * f, 3, 2)
        self.GroupNorm_2 = GroupNorm(4 * f)
        for i in range(cfg.num_res_blocks):
            self.add_module(f"res_{i}", ResnetBlock(4 * f))
        self.ConvTranspose_0 = SameConvTranspose2d(4 * f, 2 * f)
        self.GroupNorm_3 = GroupNorm(2 * f)
        self.ConvTranspose_1 = SameConvTranspose2d(2 * f, f)
        self.GroupNorm_4 = GroupNorm(f)
        self.Conv_3 = SameConv2d(f, cfg.out_channels, 7)

    def forward(self, x: torch.Tensor, out_dtype=None) -> torch.Tensor:
        """``out_dtype`` float32 on a bfloat16 model returns the last tanh
        unrounded, as XLA leaves a bf16 value that only a convert to
        float32 reads (``xla_allow_excess_precision``)."""
        h = x.permute(0, 3, 1, 2)
        h = F.relu(self.GroupNorm_0(self.Conv_0(h)))
        h = F.relu(self.GroupNorm_1(self.Conv_1(h)))
        h = F.relu(self.GroupNorm_2(self.Conv_2(h)))
        for i in range(self.cfg.num_res_blocks):
            h = getattr(self, f"res_{i}")(h)
        h = F.relu(self.GroupNorm_3(self.ConvTranspose_0(h)))
        h = F.relu(self.GroupNorm_4(self.ConvTranspose_1(h)))
        h = self.Conv_3(h).to(out_dtype or x.dtype)
        h = xla_tanh(h) if h.device.type == "cpu" else torch.tanh(h)
        return h.permute(0, 2, 3, 1)


class PatchDiscriminator(nn.Module):
    """70x70 PatchGAN: [B, H, W, 6] (the dirty page beside a clean one, in
    [-1, 1]) -> patch logits [B, H/8, W/8, 1]; flax's module names."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        f = cfg.base_channels
        self.Conv_0 = SameConv2d(cfg.in_channels, f, 4, 2)
        self.Conv_1 = SameConv2d(f, 2 * f, 4, 2)
        self.GroupNorm_0 = GroupNorm(2 * f)
        self.Conv_2 = SameConv2d(2 * f, 4 * f, 4, 2)
        self.GroupNorm_1 = GroupNorm(4 * f)
        self.Conv_3 = SameConv2d(4 * f, 8 * f, 4)
        self.GroupNorm_2 = GroupNorm(8 * f)
        self.Conv_4 = SameConv2d(8 * f, 1, 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(self.Conv_0(x.permute(0, 3, 1, 2)), 0.2)
        h = F.leaky_relu(self.GroupNorm_0(self.Conv_1(h)), 0.2)
        h = F.leaky_relu(self.GroupNorm_1(self.Conv_2(h)), 0.2)
        h = F.leaky_relu(self.GroupNorm_2(self.Conv_3(h)), 0.2)
        return self.Conv_4(h).permute(0, 2, 3, 1)
