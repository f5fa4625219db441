"""CRAFT text detector (port of ``marie_tpu/models/craft.py``).

NHWC at the public interface, NCHW inside.  What must match the flax
model: the space-to-depth stem and depth-to-space head reshape orders
(done in NHWC exactly as flax does them), 'SAME' padding of the 3x3
convs, BatchNorm eps 1e-5, and ``jax.image.resize`` bilinear.  The U-Net
resize only ever upsamples, where JAX's antialiasing has no effect, so it
maps to ``F.interpolate(mode="bilinear", align_corners=False,
antialias=False)``.

bfloat16 on the CPU follows XLA's CPU rounding points by default, so
that the port's CPU path stays near the JAX package's golden: XLA
computes each bf16 op in float32 and rounds its result to bf16 (the
convolution's sum included, before the bias is added), computes
BatchNorm as four rounded ops (``x - mean``, ``* bf16(bf16(rsqrt(bf16(
var + eps))) * scale)``, ``+ bias``, ``relu``), resizes with bf16
weights one axis at a time (in the order jnp.einsum picks) rounding
after each, and expands the sigmoid as ``1 / bf16(bf16(exp(-x)) + 1)``
with the last division left in float32.  What it cannot match is the
convolutions' float32 summation order (XLA's Eigen kernels against
oneDNN's): on the shipped pages ~2e-5 of a layer's outputs land one
bf16 ulp apart from 576-term sums on (``scripts/probe_craft_xla.py``).
On the card the model runs cuDNN's bf16 modules, which round where
torch's modules round on the CPU (``set_cpu_bf16_rounding("torch")``,
for holding the card to the CPU).
"""

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from marie_tpu_torch.models.configs import CraftConfig

BN_EPS = 1e-5


#: CPU bf16 rounding points: XLA's (the JAX package's CPU results), or
#: torch's modules (the card's cuDNN rounding points, for card-vs-CPU
#: checks)
CPU_BF16_ROUNDINGS = ("xla", "torch")


def _xla_rounding(module: nn.Module, x: torch.Tensor) -> bool:
    """Whether ``x`` takes the path that rounds where XLA's CPU bf16 does."""
    return (module.cpu_bf16_rounding == "xla" and x.dtype == torch.bfloat16
            and x.device.type == "cpu")


def _bf16_op(y: torch.Tensor) -> torch.Tensor:
    """A float32 result rounded to bf16 and widened back, as XLA rounds
    every bf16 op."""
    return y.to(torch.bfloat16).float()


def _channel(v: torch.Tensor) -> torch.Tensor:
    return v.float()[None, :, None, None]


class ConvBNRelu(nn.Module):
    cpu_bf16_rounding = "xla"

    def __init__(self, cin: int, cout: int, kernel: int = 3):
        super().__init__()
        self.Conv_0 = nn.Conv2d(cin, cout, kernel, padding=kernel // 2)
        self.BatchNorm_0 = nn.BatchNorm2d(cout, eps=BN_EPS)

    def forward(self, x):
        if _xla_rounding(self, x):
            return self._forward_xla(x).to(torch.bfloat16)
        return F.relu(self.BatchNorm_0(self.Conv_0(x)))

    def _forward_xla(self, x: torch.Tensor) -> torch.Tensor:
        """bf16 [B, C, H, W] -> the flax block's bf16 values (as float32)
        with XLA's CPU rounding points."""
        conv, bn = self.Conv_0, self.BatchNorm_0
        y = _bf16_op(F.conv2d(x.float(), conv.weight.float(), None, padding=conv.padding))
        y = _bf16_op(y + _channel(conv.bias))
        y = _bf16_op(y - _channel(bn.running_mean))
        eps = float(torch.tensor(BN_EPS, dtype=torch.bfloat16))  # flax adds eps in bf16
        inv = _bf16_op(torch.rsqrt(_bf16_op(bn.running_var.float() + eps)))
        y = _bf16_op(y * _channel(_bf16_op(inv * bn.weight.float())))
        y = _bf16_op(y + _channel(bn.bias))
        return torch.relu(y)


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


def resize_bilinear(x: torch.Tensor, hw, xla_rounding: bool = True) -> torch.Tensor:
    """``jax.image.resize(..., "bilinear")`` for an NCHW upsample; a bf16
    ``x`` on the CPU rounds as XLA does unless ``xla_rounding`` is off."""
    if xla_rounding and x.dtype == torch.bfloat16 and x.device.type == "cpu":
        # jnp.einsum contracts one axis at a time, in the order of fewer
        # flops (opt_einsum's "optimal" path), H first on a tie
        (h, w), (oh, ow) = x.shape[-2:], hw
        if oh * w * h + oh * ow * w <= h * ow * w + oh * ow * h:
            return _resize_axis_bf16(_resize_axis_bf16(x, oh, 2), ow, 3)
        return _resize_axis_bf16(_resize_axis_bf16(x, ow, 3), oh, 2)
    return F.interpolate(x, size=tuple(hw), mode="bilinear",
                         align_corners=False, antialias=False)


def _upsample_taps(n_in: int, n_out: int):
    """``jax.image.resize``'s bilinear weight matrix for an upsample of one
    axis (``compute_weight_mat`` in float32, then cast to bf16 as JAX casts
    it to the image's dtype), as two taps per output: (i0, i1, w0, w1)."""
    if n_out < n_in:
        raise ValueError(f"the bf16 CPU resize only upsamples: {n_in} -> {n_out}")
    f32 = np.float32
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * f32(1.0 / (n_out / n_in)) - f32(0.5)
    w = np.maximum(f32(0), f32(1) - np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]))
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000 * np.finfo(f32).eps, w / np.where(total != 0, total, 1), 0)
    w = np.where(((sample >= -0.5) & (sample <= n_in - 0.5))[None, :], w, 0).astype(f32)
    w = torch.from_numpy(w).to(torch.bfloat16).float()  # [n_in, n_out]
    below = torch.floor(torch.from_numpy(sample)).long()
    i0 = torch.clamp(below, 0, n_in - 1)
    i1 = torch.clamp(below + 1, 0, n_in - 1)
    cols = torch.arange(n_out)
    w0 = w[i0, cols]
    w1 = torch.where(i1 != i0, w[i1, cols], torch.zeros(()))
    rest = w != 0
    rest[i0, cols] = False
    rest[i1, cols] = False
    if bool(rest.any()):
        raise AssertionError(f"an upsample {n_in} -> {n_out} has more than two taps")
    return i0, i1, w0, w1


def _resize_axis_bf16(x: torch.Tensor, n_out: int, axis: int) -> torch.Tensor:
    """One axis of the bf16 resize: the two taps' products are exact in
    float32, so their sum rounded to bf16 is what XLA's dot gives."""
    if x.shape[axis] == n_out:
        return x
    i0, i1, w0, w1 = _upsample_taps(x.shape[axis], n_out)
    shape = [1] * x.ndim
    shape[axis] = n_out
    xf = x.float()
    y = (xf.index_select(axis, i0) * w0.view(shape)
         + xf.index_select(axis, i1) * w1.view(shape))
    return y.to(torch.bfloat16)


def depth_to_space(x: torch.Tensor, r: int, nc: int) -> torch.Tensor:
    """NHWC [B, h, w, r*r*nc] -> [B, h*r, w*r, nc] as the flax heads do it:
    reshape to [B, h, w, r, r, nc], axes (0, 1, 3, 2, 4, 5) (channel
    ``(sy * r + sx) * nc + c``; not ``F.pixel_shuffle``'s order)."""
    if r == 1:
        return x
    b, hh, ww, _ = x.shape
    out = x.reshape(b, hh, ww, r, r, nc).permute(0, 1, 3, 2, 4, 5)
    return out.reshape(b, r * hh, r * ww, nc)


class UpBlock(nn.Module):
    """Upsample to the skip's size, concat [x, skip], 1x1 then 3x3 conv."""

    cpu_bf16_rounding = "xla"

    def __init__(self, cin: int, cskip: int, mid: int, out: int):
        super().__init__()
        self.ConvBNRelu_0 = ConvBNRelu(cin + cskip, mid, kernel=1)
        self.ConvBNRelu_1 = ConvBNRelu(mid, out, kernel=3)

    def forward(self, x, skip):
        x = resize_bilinear(x, skip.shape[-2:], self.cpu_bf16_rounding == "xla")
        x = torch.cat([x, skip], dim=1)
        return self.ConvBNRelu_1(self.ConvBNRelu_0(x))


class CRAFT(nn.Module):
    """[B, H, W, C] float in [0, 1] -> [B, H/2, W/2, 2] (region, affinity)
    on the stride-``cfg.out_stride`` grid."""

    cpu_bf16_rounding = "xla"

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

    def _stem(self, images: torch.Tensor) -> torch.Tensor:
        """NHWC images -> the NCHW input of stage1 (space-to-depth first
        when the config has the stem)."""
        f = self.cfg.stem_stride
        if f > 1:
            b, h, w, ch = images.shape
            images = images.reshape(b, h // f, f, w // f, f, ch)
            images = images.permute(0, 1, 3, 2, 4, 5).reshape(
                b, h // f, w // f, f * f * ch)
        return images.permute(0, 3, 1, 2)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        f = self.cfg.stem_stride
        x = self._stem(images)
        s1 = self.stage1(x)
        s2 = self.stage2(F.max_pool2d(s1, 2, 2))
        s3 = self.stage3(F.max_pool2d(s2, 2, 2))
        s4 = self.stage4(F.max_pool2d(s3, 2, 2))
        s5 = self.stage5(F.max_pool2d(s4, 2, 2))
        u = self.up1(s5, s4)
        u = self.up2(u, s3)
        u = self.up3(u, s2)
        h = self.head2(self.head1(u))
        if _xla_rounding(self, h):
            out = self._head_xla(h)
        else:
            out = torch.sigmoid(self.head_out(h))
        out = out.permute(0, 2, 3, 1)
        if self.cfg.head_d2s:
            out = depth_to_space(out, f, self.cfg.num_classes)
        return out

    #: the VGG stages :meth:`trunk` can stop at
    TRUNK_STAGES = ("stage1", "stage2", "stage3", "stage4", "stage5")

    def trunk(self, images: torch.Tensor, layer: str = "stage3") -> torch.Tensor:
        """[B, H, W, C] float in [0, 1] -> the named VGG stage's output
        [B, h, w, C'] (NHWC), the feature grid the template matchers read
        (flax's ``capture_intermediates`` of that stage); ``stage3`` is at
        stride 4 (times the stem's) with ``4 * base_channels`` channels."""
        if layer not in self.TRUNK_STAGES:
            raise ValueError(f"layer is one of {self.TRUNK_STAGES}, got {layer!r}")
        x = self._stem(images)
        for i, name in enumerate(self.TRUNK_STAGES):
            if i:
                x = F.max_pool2d(x, 2, 2)
            x = getattr(self, name)(x)
            if name == layer:
                return x.permute(0, 2, 3, 1)
        raise AssertionError(layer)

    def set_cpu_bf16_rounding(self, mode: str) -> "CRAFT":
        """Where a bf16 forward on the CPU rounds: ``"xla"`` (default)
        or ``"torch"`` (torch's modules, as the card's cuDNN path)."""
        if mode not in CPU_BF16_ROUNDINGS:
            raise ValueError(f"cpu_bf16_rounding is one of {CPU_BF16_ROUNDINGS}, got {mode!r}")
        for m in self.modules():
            if isinstance(m, (CRAFT, UpBlock, ConvBNRelu)):
                m.cpu_bf16_rounding = mode
        return self

    def _head_xla(self, h: torch.Tensor) -> torch.Tensor:
        """The 1x1 head and XLA's CPU expansion of the bf16 sigmoid; the
        last division stays float32 (XLA drops the round trip to bf16
        before the caller's cast to float32)."""
        conv = self.head_out
        y = _bf16_op(F.conv2d(h.float(), conv.weight.float()))
        y = _bf16_op(y + _channel(conv.bias))
        e = _bf16_op(torch.exp(_bf16_op(-y)))
        return 1.0 / _bf16_op(e + 1.0)
