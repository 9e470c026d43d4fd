"""S2DF_3dense context network, NCHW.

Counterpart of ``meta_interpolation_tpu/models/dain/s2df.py`` (reference
``S2D_models/S2DF.py:148-196``): a bias-free conv7×7 3→64 + ReLU stem, then
two dilated residual blocks (dilations 4 and 8; conv3×3(dil) + ReLU +
conv3×3, residual add, ReLU; no BN, no biases). Dense output: concat[raw(3),
stem(64), block2(64), block3(64)] = 195 channels.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .. import layers

CTX_CHANNELS = 3 * 64 + 3  # 195


def _conv(in_ch, out_ch, k, gen, padding, dilation=1) -> nn.Conv2d:
    conv = nn.Conv2d(in_ch, out_ch, k, padding=padding, dilation=dilation,
                     bias=False)
    return layers.normal_init_(conv, math.sqrt(2.0 / (k * k * out_ch)), gen)


class BasicBlock(nn.Module):
    def __init__(self, ch: int, dilation: int,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = _conv(ch, ch, 3, gen, padding=dilation,
                           dilation=dilation)
        self.conv2 = _conv(ch, ch, 3, gen, padding=1)

    def forward(self, x):
        out = self.conv2(F.relu(self.conv1(x)))
        return F.relu(out + x)


class S2DF(nn.Module):
    """(N, 3, H, W) → (N, 195, H, W) dense context features."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.block1 = nn.Sequential(_conv(3, 64, 7, generator, padding=3))
        self.block2 = BasicBlock(64, 4, generator)
        self.block3 = BasicBlock(64, 8, generator)

    def forward(self, x):
        h1 = F.relu(self.block1(x))
        h2 = self.block2(h1)
        h3 = self.block3(h2)
        return torch.cat([x, h1, h2, h3], 1)
