"""Model size configs — the presets of ``marie_tpu/models/configs.py``
that the port runs: the DiT detector's ViT (``dit_synth``,
``dit_synth_s1``), TextFuseNet (``synth``,
``synth_s2``), CRAFT ``fast_s2d2``, TrOCR ``fast_v3_g2_d6``, the
LayoutLM ``base``, ``synth`` and ``tiny`` presets, the CRNN, the pix2pix
generator (default, ``synth``, ``tiny``), CRAFT ``base`` (the template
matchers' trunk), the boundary regressor (default, ``tiny``), and the
``tiny`` CPU-test presets of CRAFT, TrOCR and the CRNN.  Field names
and defaults are the JAX package's, so a config means the same model on
both sides."""

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: Tuple[int, int] = (384, 384)  # (H, W)
    # int = square patches; (ph, pw) = rectangular (48x16 full-height
    # word-crop patches: one token per vertical glyph slice)
    patch_size: int | Tuple[int, int] = 16
    hidden_dim: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    channels: int = 3
    use_cls_token: bool = True
    # the DiT detector's dense head: the patch grid is conv-upsampled to
    # head_stride * subpixel, and the 1x1 head predicts subpixel^2 phase
    # maps per channel, depth-to-spaced to head_stride
    head_stride: int = 4
    subpixel: int = 1

    @property
    def patch_hw(self) -> Tuple[int, int]:
        p = self.patch_size
        return (p, p) if isinstance(p, int) else tuple(p)

    @property
    def seq_len(self) -> int:
        h, w = self.image_size
        ph, pw = self.patch_hw
        n = (h // ph) * (w // pw)
        return n + (1 if self.use_cls_token else 0)

    @staticmethod
    def dit_synth() -> "ViTConfig":
        """The DiT detector of ``dit-synth``: 512x384 pages in 16x16
        patches (768 tokens), 256 wide, 6 layers of 4 heads, stride-2
        head."""
        return ViTConfig(
            image_size=(512, 384), patch_size=16, hidden_dim=256,
            num_layers=6, num_heads=4, mlp_dim=1024, use_cls_token=False,
            head_stride=2,
        )

    @staticmethod
    def dit_synth_s1() -> "ViTConfig":
        """``dit_synth`` with a 2x2 sub-pixel head: the stride-1 grid off
        the stride-2 conv stack (``dit-s1-synth``)."""
        return dataclasses.replace(ViTConfig.dit_synth(), head_stride=1, subpixel=2)


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    vocab_size: int = 512
    hidden_dim: int = 768
    num_layers: int = 6
    num_heads: int = 12
    mlp_dim: int = 3072
    max_len: int = 48
    bos_id: int = 0
    eos_id: int = 1
    pad_id: int = 2
    # grouped-query CROSS-attention K/V heads (None = num_heads)
    cross_kv_heads: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class TrOCRConfig:
    encoder: ViTConfig = dataclasses.field(default_factory=ViTConfig)
    decoder: DecoderConfig = dataclasses.field(default_factory=DecoderConfig)

    @staticmethod
    def fast_v3_g2_d6() -> "TrOCRConfig":
        """The serving recogniser (``trocr-fast3g2d6ov-synth``): 48x320
        crops in 48x16 patches (20 tokens), 384 wide, 6 encoder and 6
        decoder layers, 6 heads, 2 shared cross-attention K/V heads."""
        return TrOCRConfig(
            encoder=ViTConfig(
                image_size=(48, 320),
                patch_size=(48, 16),
                hidden_dim=384,
                num_layers=6,
                num_heads=6,
                mlp_dim=1536,
                use_cls_token=False,
            ),
            decoder=DecoderConfig(
                vocab_size=512,
                hidden_dim=384,
                num_layers=6,
                num_heads=6,
                mlp_dim=1536,
                max_len=32,
                cross_kv_heads=2,
            ),
        )

    @staticmethod
    def tiny() -> "TrOCRConfig":
        """CPU-test preset."""
        return TrOCRConfig(
            encoder=ViTConfig(
                image_size=(32, 64),
                patch_size=16,
                hidden_dim=64,
                num_layers=2,
                num_heads=2,
                mlp_dim=128,
                use_cls_token=False,
            ),
            decoder=DecoderConfig(
                vocab_size=104,
                hidden_dim=64,
                num_layers=2,
                num_heads=2,
                mlp_dim=128,
                max_len=12,
            ),
        )


@dataclasses.dataclass(frozen=True)
class CraftConfig:
    """CRAFT detector (VGG16-BN U-Net)."""

    base_channels: int = 32
    num_classes: int = 2  # region + affinity heatmaps
    # space-to-depth input stem factor: stage1 runs at 1/stem_stride
    stem_stride: int = 1
    # sub-pixel head: depth-to-space the head back to the stride-2 grid
    head_d2s: bool = False

    @property
    def out_stride(self) -> int:
        """Heatmap-grid to page-pixel factor."""
        return 2 if self.head_d2s else 2 * self.stem_stride

    @staticmethod
    def base() -> "CraftConfig":
        """The full-width trunk (``craft-synth``; the DIM and VQNNF
        matchers' features)."""
        return CraftConfig(base_channels=64)

    @staticmethod
    def fast_s2d2() -> "CraftConfig":
        """The serving detector (``craft-s2d2-synth``): half-width trunk
        behind a 2x space-to-depth stem, 2x depth-to-space head."""
        return CraftConfig(base_channels=32, stem_stride=2, head_d2s=True)

    @staticmethod
    def tiny() -> "CraftConfig":
        return CraftConfig(base_channels=8)


@dataclasses.dataclass(frozen=True)
class CRNNConfig:
    """CTC recogniser (the trained ``crnn-synth`` is the default)."""

    num_classes: int = 96  # charset + blank
    input_height: int = 32
    feature_dim: int = 256
    hidden_dim: int = 256
    backbone: str = "resnet"  # vgg | resnet

    @staticmethod
    def tiny() -> "CRNNConfig":
        return CRNNConfig(feature_dim=32, hidden_dim=32, backbone="vgg")


@dataclasses.dataclass(frozen=True)
class LayoutLMConfig:
    """LayoutLMv3-style multimodal encoder of the document heads."""

    vocab_size: int = 50265
    hidden_dim: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    max_seq_len: int = 512
    max_2d_pos: int = 1024  # coordinate buckets
    image_size: Tuple[int, int] = (224, 224)
    patch_size: int = 16
    use_image: bool = True
    num_labels: int = 2
    dropout: float = 0.0

    @property
    def n_patches(self) -> int:
        return (self.image_size[0] // self.patch_size) * (self.image_size[1] // self.patch_size)

    @staticmethod
    def base(num_labels: int = 2) -> "LayoutLMConfig":
        """LayoutLMv3-base width: 768 wide, 12 layers of 12 heads, 3,072
        MLP, 512 tokens, a 224x224 image in 196 patches."""
        return LayoutLMConfig(num_labels=num_labels)

    @staticmethod
    def synth(num_labels: int) -> "LayoutLMConfig":
        """The synthetic-trained head config of the JAX package
        (``train/layout.py``)."""
        return LayoutLMConfig(
            vocab_size=8192,
            hidden_dim=256,
            num_layers=4,
            num_heads=4,
            mlp_dim=1024,
            max_seq_len=128,
            use_image=False,
            num_labels=num_labels,
        )

    @staticmethod
    def tiny(num_labels: int = 2) -> "LayoutLMConfig":
        return LayoutLMConfig(
            vocab_size=128,
            hidden_dim=64,
            num_layers=2,
            num_heads=2,
            mlp_dim=128,
            max_seq_len=64,
            image_size=(32, 32),
            use_image=True,
            num_labels=num_labels,
        )


@dataclasses.dataclass(frozen=True)
class Pix2PixConfig:
    """Overlay-cleanup generator (the pix2pix ``resnet_9blocks`` of upstream
    marie's overlay)."""

    base_channels: int = 64
    num_res_blocks: int = 9
    in_channels: int = 3
    out_channels: int = 3

    @staticmethod
    def synth() -> "Pix2PixConfig":
        """The JAX package's synthetic-trained generator
        (``marie_tpu/train/overlay.py``, ``model_zoo/pix2pix-synth``)."""
        return Pix2PixConfig(base_channels=32, num_res_blocks=6)

    @staticmethod
    def tiny() -> "Pix2PixConfig":
        return Pix2PixConfig(base_channels=8, num_res_blocks=2)


@dataclasses.dataclass(frozen=True)
class BoundaryConfig:
    """The document-boundary corner regressor (``models/boundary.py``)."""

    input_hw: Tuple[int, int] = (192, 256)
    base_channels: int = 24
    num_stages: int = 5
    mlp_dim: int = 256

    @staticmethod
    def tiny() -> "BoundaryConfig":
        return BoundaryConfig(input_hw=(48, 64), base_channels=8, num_stages=3, mlp_dim=32)


@dataclasses.dataclass(frozen=True)
class TextFuseNetConfig:
    """TextFuseNet (``marie_tpu/models/textfusenet.py``'s config)."""

    channels: int = 64  # FPN / fuse-module channel width
    backbone_widths: Tuple[int, int, int] = (32, 64, 128)
    pool: int = 7  # ROI pooler resolution
    max_words: int = 128  # K word-instance slots
    max_chars: int = 512  # M char-instance slots
    contain_thresh: float = 0.9  # a char is a word's when inter / char area > this
    head_stride: int = 4  # word/char map stride: 4 (P3) or 2 (sub-pixel head)

    @staticmethod
    def synth() -> "TextFuseNetConfig":
        """``textfusenet-synth``."""
        return TextFuseNetConfig()

    @staticmethod
    def synth_s2() -> "TextFuseNetConfig":
        """``textfusenet-s2-synth``: the stride-2 sub-pixel head."""
        return TextFuseNetConfig(head_stride=2)
