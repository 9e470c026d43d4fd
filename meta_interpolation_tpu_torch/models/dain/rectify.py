"""Rectify network — MultipleBasicBlock_4, the only part of DAIN that
scene adaptation changes. NCHW.

Counterpart of ``meta_interpolation_tpu/models/dain/rectify.py`` (reference
``Resblock/BasicBlock.py:152-215``): conv7×7 (437→128) + ReLU, three
bias-free residual blocks (conv3×3 + ReLU + conv3×3, add, ReLU; no BN),
conv3×3 (128→3). Init normal(0, √(2/n)), n = k·k·out, zero bias.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .. import layers


def _conv(in_ch, out_ch, k, gen, bias=True) -> nn.Conv2d:
    conv = nn.Conv2d(in_ch, out_ch, k, padding=k // 2, bias=bias)
    return layers.normal_init_(conv, math.sqrt(2.0 / (k * k * out_ch)), gen)


class BasicBlock(nn.Module):
    def __init__(self, ch: int, gen: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = _conv(ch, ch, 3, gen, bias=False)
        self.conv2 = _conv(ch, ch, 3, gen, bias=False)

    def forward(self, x):
        return F.relu(self.conv2(F.relu(self.conv1(x))) + x)


class Rectify(nn.Module):
    """(N, in_channels, H, W) → (N, 3, H, W) residual."""

    def __init__(self, in_channels: int = 437, intermediate: int = 128,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator
        self.block1 = nn.Sequential(_conv(in_channels, intermediate, 7, gen))
        self.block2 = BasicBlock(intermediate, gen)
        self.block3 = BasicBlock(intermediate, gen)
        self.block4 = BasicBlock(intermediate, gen)
        self.block5 = nn.Sequential(_conv(intermediate, 3, 3, gen))

    def forward(self, x):
        x = F.relu(self.block1(x))
        x = self.block4(self.block3(self.block2(x)))
        return self.block5(x)
