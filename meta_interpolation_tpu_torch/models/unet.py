"""Tunable U-Net used by RRIN (reference ``rrin/unet.py``).

Counterpart of ``meta_interpolation_tpu/models/unet.py``: a depth-d encoder
of double-conv blocks (3×3, LeakyReLU 0.1) with 2×2 average-pool
downsampling, a mid conv, and decoder blocks of bilinear ×2 upsample
(align_corners=False) + conv, concatenated with the skip and run through a
double-conv block. Channel widths 2^(wf+i), wf = 5.

Parameter names are the JAX tree's paths (``down_path.{i}.block.{0,2}``,
``midconv``, ``up_path.{j}.up.1``, ``up_path.{j}.conv_block.block.{0,2}``,
``last``), so ``core/checkpoint.params_from_jax`` bridges them as they are.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from . import layers

SLOPE = 0.1


class ConvBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.block = nn.Sequential(
            layers.conv3x3(in_ch, out_ch, gen), nn.LeakyReLU(SLOPE),
            layers.conv3x3(out_ch, out_ch, gen), nn.LeakyReLU(SLOPE))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)


class UpBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.up = nn.Sequential(layers.Upsample(2, align_corners=False),
                                layers.conv3x3(in_ch, out_ch, gen))
        self.conv_block = ConvBlock(in_ch, out_ch, gen)

    def forward(self, x: torch.Tensor, bridge: torch.Tensor) -> torch.Tensor:
        up = self.up(x)
        # centre-crop the skip to the upsampled size (a no-op at ×128)
        uh, uw = up.shape[2], up.shape[3]
        dy = (bridge.shape[2] - uh) // 2
        dx = (bridge.shape[3] - uw) // 2
        bridge = bridge[:, :, dy:dy + uh, dx:dx + uw]
        return self.conv_block(torch.cat([up, bridge], 1))


class UNet(nn.Module):
    def __init__(self, in_channels: int, n_classes: int, depth: int,
                 wf: int = 5, generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator
        self.depth = depth
        self.down_path = nn.ModuleList()
        prev = in_channels
        for i in range(depth):
            self.down_path.append(ConvBlock(prev, 2 ** (wf + i), gen))
            prev = 2 ** (wf + i)
        self.midconv = layers.conv3x3(prev, prev, gen)
        self.up_path = nn.ModuleList()
        for i in reversed(range(depth - 1)):
            self.up_path.append(UpBlock(prev, 2 ** (wf + i), gen))
            prev = 2 ** (wf + i)
        self.last = layers.conv3x3(prev, n_classes, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        blocks = []
        for i, down in enumerate(self.down_path):
            x = down(x)
            if i != self.depth - 1:
                blocks.append(x)
                x = layers.avg_pool(x, 2)
        x = layers.leaky_relu(self.midconv(x), SLOPE)
        for j, up in enumerate(self.up_path):
            x = up(x, blocks[-j - 1])
        return self.last(x)
