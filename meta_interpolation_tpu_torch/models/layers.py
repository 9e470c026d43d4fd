"""The layers SepConv uses, in NCHW.

Counterparts of ``meta_interpolation_tpu/models/layers.py``, which works
in NHWC with HWIO kernels; here activations are NCHW and conv weights
OIHW (:func:`conv3x3` builds a ``nn.Conv2d``, whose state-dict names the
weight bridge maps onto the JAX ``kernel``/``bias`` leaves).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn


def conv3x3(in_ch: int, out_ch: int,
            generator: Optional[torch.Generator] = None) -> nn.Conv2d:
    """3×3 stride-1 conv, padding 1, xavier-uniform weight and zero bias
    (``meta_interpolation_tpu/models/cain.py:34`` ``_xavier_conv``)."""
    conv = nn.Conv2d(in_ch, out_ch, 3, padding=1)
    bound = math.sqrt(6.0 / ((in_ch + out_ch) * 9))
    with torch.no_grad():
        conv.weight.uniform_(-bound, bound, generator=generator)
        conv.bias.zero_()
    return conv


def replicate_pad(x: torch.Tensor, pad: Union[int, Sequence[int]]
                  ) -> torch.Tensor:
    """Edge-replicate pad; ``pad`` is an int or (left, right, top, bottom),
    the order ``F.pad`` takes."""
    if isinstance(pad, int):
        pad = (pad, pad, pad, pad)
    return F.pad(x, tuple(pad), mode="replicate")


def avg_pool(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    return F.avg_pool2d(x, window)


def upsample_bilinear(x: torch.Tensor, scale: int = 2,
                      align_corners: bool = False) -> torch.Tensor:
    return F.interpolate(x, scale_factor=scale, mode="bilinear",
                         align_corners=align_corners)


class Upsample(nn.Module):
    """Bilinear ×scale upsample as a module, so it holds an index in an
    ``nn.Sequential`` as the reference's ``nn.Upsample`` does."""

    def __init__(self, scale: int = 2, align_corners: bool = True):
        super().__init__()
        self.scale = scale
        self.align_corners = align_corners

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upsample_bilinear(x, self.scale, self.align_corners)
