"""CRNN scene-text recogniser with a CTC head (port of
``marie_tpu/models/crnn.py``): a VGG or ResNet convolution stack that
brings 32-pixel-high crops to one row of W/4 columns, two bidirectional
LSTMs over the columns, each followed by a projection, and the CTC
logits.

The modules carry the flax names (``ConvBlock_0``, ``ResBlock_1``,
``Conv_0``, ``lstm_proj_0``, ``ctc_head``), so the weight bridge
(``registry/convert.py``) maps a flax path to a torch key by name.  The
exceptions are the LSTMs: flax makes each direction an
``OptimizedLSTMCell_<n>`` (layer i's forward cell is 2i, its backward
cell 2i + 1), while the port runs each layer as one bidirectional
``nn.LSTM`` (cuDNN on the card); :attr:`CRNN.flax_lstm_cells` maps the
one to the other.  The input is NHWC as in the JAX version; inside the
stack runs NCHW.  BatchNorm runs in eval mode (flax's epsilon, 1e-5).
The backward direction reads every column, the white padding of a
width bucket too, as flax's ``nn.RNN(reverse=True)`` does without
sequence lengths: nothing is packed.
"""

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from marie_tpu_torch.models.configs import CRNNConfig


def _conv3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1)  # SAME for a 3x3 window


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5)


class ConvBlock(nn.Module):
    """3x3 conv, BatchNorm, ReLU, then an optional max pool (VALID)."""

    def __init__(self, cin: int, features: int, pool: Optional[Tuple[int, int]] = (2, 2)):
        super().__init__()
        self.Conv_0 = _conv3(cin, features)
        self.BatchNorm_0 = _bn(features)
        self.pool = pool

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        if self.pool:
            x = F.max_pool2d(x, self.pool, self.pool)
        return x


class ResBlock(nn.Module):
    """Two 3x3 conv + BatchNorm layers around a residual; a 1x1 conv
    (``Conv_2``) projects the input where the width changes."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.Conv_0 = _conv3(cin, features)
        self.BatchNorm_0 = _bn(features)
        self.Conv_1 = _conv3(features, features)
        self.BatchNorm_1 = _bn(features)
        if cin != features:
            self.Conv_2 = nn.Conv2d(cin, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        h = self.BatchNorm_1(self.Conv_1(h))
        if hasattr(self, "Conv_2"):
            x = self.Conv_2(x)
        return F.relu(x + h)


class CRNN(nn.Module):
    """[B, 32, W, 1] grayscale crops -> [B, W/4, num_classes] CTC logits."""

    #: {flax cell: (torch LSTM, parameter suffix)} of the two layers'
    #: forward and backward cells
    flax_lstm_cells: Dict[str, Tuple[str, str]] = {
        f"OptimizedLSTMCell_{2 * i + d}": (f"lstm_{i}", "_reverse" if d else "")
        for i in range(2) for d in range(2)
    }

    def __init__(self, cfg: CRNNConfig):
        super().__init__()
        if cfg.backbone not in ("vgg", "resnet"):
            raise ValueError(f"backbone must be 'vgg' or 'resnet', got {cfg.backbone!r}")
        self.cfg = cfg
        f, hd = cfg.feature_dim, cfg.hidden_dim
        if cfg.backbone == "resnet":
            self.ConvBlock_0 = ConvBlock(1, f // 4, (2, 2))  # 16 x W/2
            self.ResBlock_0 = ResBlock(f // 4, f // 2)
            self.ResBlock_1 = ResBlock(f // 2, f)
            self.ResBlock_2 = ResBlock(f, f)
        else:
            self.ConvBlock_0 = ConvBlock(1, f // 4, (2, 2))
            self.ConvBlock_1 = ConvBlock(f // 4, f // 2, (2, 2))  # 8 x W/4
            self.ConvBlock_2 = ConvBlock(f // 2, f, (2, 1))  # 4 x W/4
            self.ConvBlock_3 = ConvBlock(f, f, (2, 1))  # 2 x W/4
        self.Conv_0 = nn.Conv2d(f, f, (2, 1))  # 1 x W/4, VALID
        for i in range(2):
            self.add_module(f"lstm_{i}", nn.LSTM(f if i == 0 else hd, hd, batch_first=True,
                                                 bidirectional=True))
            self.add_module(f"lstm_proj_{i}", nn.Linear(2 * hd, hd))
        self.ctc_head = nn.Linear(hd, cfg.num_classes)
        self.eval()

    def features(self, images: torch.Tensor) -> torch.Tensor:
        """[B, 32, W, 1] -> the column sequence [B, W/4, feature_dim]."""
        x = images.permute(0, 3, 1, 2)
        if self.cfg.backbone == "resnet":
            x = self.ConvBlock_0(x)
            x = F.max_pool2d(self.ResBlock_0(x), (2, 2), (2, 2))  # 8 x W/4
            x = F.max_pool2d(self.ResBlock_1(x), (2, 1), (2, 1))  # 4 x W/4
            x = F.max_pool2d(self.ResBlock_2(x), (2, 1), (2, 1))  # 2 x W/4
        else:
            for i in range(4):
                x = getattr(self, f"ConvBlock_{i}")(x)
        return self.Conv_0(x)[:, :, 0].transpose(1, 2)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        seq = self.features(images)
        for i in range(2):
            seq, _ = getattr(self, f"lstm_{i}")(seq)  # [fwd, bwd] concatenated
            seq = getattr(self, f"lstm_proj_{i}")(seq)
        return self.ctc_head(seq)
