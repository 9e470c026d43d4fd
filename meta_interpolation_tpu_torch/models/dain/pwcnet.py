"""PWC-DC optical flow network, NCHW.

Counterpart of ``meta_interpolation_tpu/models/dain/pwcnet.py`` (reference
``PWCNet/PWCNet.py:40-317``): a 6-level siamese feature pyramid (LeakyReLU
0.1 convs), an 81-channel correlation cost volume at each level
(``ops/correlation.py``), DenseNet-style decoders (each conv's output
concatenated before its input), flow and feature upsampling by 4×4
stride-2 transposed convs (``nn.ConvTranspose2d``), masked backward warping
between levels with per-level flow scales (0.625, 1.25, 2.5, 5.0), and a
dilated context network that refines the quarter-resolution flow.

Names are the JAX tree's: ``conv1a.0``, ``conv6_4.0``, ``dc_conv3.0``, and
the flat ``predict_flow{l}``, ``deconv{l}``, ``upfeat{l}``, ``dc_conv7``.
Init: kaiming-normal fan-in, zero bias.

:meth:`PWCNet.forward` takes two frames; :meth:`PWCNet.features` and
:meth:`PWCNet.decode` let DAIN compute the pyramid of both frames once
and decode both directions as one batch.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .. import layers
from ...ops import warp as warp_ops
from ...ops.correlation import correlation

ND = 81  # (2·4+1)² correlation channels
DD = [128, 256, 352, 416, 448]  # cumsum([128, 128, 96, 64, 32])
WIDTHS = [128, 128, 96, 64, 32]

FEATURE_SPECS = [
    # (name, in, out, stride)
    ("conv1a", 3, 16, 2), ("conv1aa", 16, 16, 1), ("conv1b", 16, 16, 1),
    ("conv2a", 16, 32, 2), ("conv2aa", 32, 32, 1), ("conv2b", 32, 32, 1),
    ("conv3a", 32, 64, 2), ("conv3aa", 64, 64, 1), ("conv3b", 64, 64, 1),
    ("conv4a", 64, 96, 2), ("conv4aa", 96, 96, 1), ("conv4b", 96, 96, 1),
    ("conv5a", 96, 128, 2), ("conv5aa", 128, 128, 1), ("conv5b", 128, 128, 1),
    ("conv6aa", 128, 196, 2), ("conv6a", 196, 196, 1), ("conv6b", 196, 196, 1),
]
LEVEL_EXTRA = {6: 0, 5: 128 + 4, 4: 96 + 4, 3: 64 + 4, 2: 32 + 4}
FLOW_SCALE = {5: 0.625, 4: 1.25, 3: 2.5, 2: 5.0}
DILATIONS = (1, 2, 4, 8, 16, 1)


def _kaiming(conv: nn.Module, fan_in: int, gen) -> nn.Module:
    return layers.normal_init_(conv, math.sqrt(2.0 / fan_in), gen)


def _conv(in_ch, out_ch, gen, stride=1, dilation=1) -> nn.Conv2d:
    return _kaiming(nn.Conv2d(in_ch, out_ch, 3, stride=stride,
                              padding=dilation, dilation=dilation),
                    in_ch * 9, gen)


def _deconv(in_ch, gen) -> nn.ConvTranspose2d:
    return _kaiming(nn.ConvTranspose2d(in_ch, 2, 4, stride=2, padding=1),
                    in_ch * 16, gen)


def warp_masked(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """The reference's warp (:158-198), quirk kept: the grid is normalised
    as 2·p/(S−1) − 1 but sampled with align_corners=False, and samples whose
    warped ones fall below 0.9999 are zeroed. x (N, C, H, W), flow
    (N, 2, H, W)."""
    n, c, h, w = x.shape
    xs = torch.arange(w, dtype=torch.float32, device=x.device)[None, None, :]
    ys = torch.arange(h, dtype=torch.float32, device=x.device)[None, :, None]
    gx = 2.0 * (xs + flow[:, 0]) / max(w - 1, 1) - 1.0
    gy = 2.0 * (ys + flow[:, 1]) / max(h - 1, 1) - 1.0
    grid = torch.stack([gx, gy], dim=-1)
    out = warp_ops.grid_sample(x, grid, align_corners=False,
                               padding_mode="zeros")
    mask = warp_ops.grid_sample(torch.ones_like(x[:, :1]), grid,
                                align_corners=False, padding_mode="zeros")
    # in the activation's type: JAX's where of two Python floats is weakly
    # typed and keeps a bf16 product bf16 (JAX pwcnet.py:103-104)
    return out * torch.where(mask < 0.9999, 0.0, 1.0).to(out.dtype)


class PWCNet(nn.Module):
    """``forward(im1, im2)``: (N, 3, H, W) frames → quarter-resolution flow
    (N, 2, H/4, W/4); DAIN scales it by 20 and upsamples ×4."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator
        for name, ic, oc, s in FEATURE_SPECS:
            self.add_module(name, nn.Sequential(_conv(ic, oc, gen, stride=s)))
        for lvl in (6, 5, 4, 3, 2):
            ch = ND + LEVEL_EXTRA[lvl]
            for i, wdt in enumerate(WIDTHS):
                self.add_module(f"conv{lvl}_{i}",
                                nn.Sequential(_conv(ch, wdt, gen)))
                ch += wdt
            self.add_module(f"predict_flow{lvl}", _conv(ch, 2, gen))
            if lvl > 2:
                self.add_module(f"deconv{lvl}", _deconv(2, gen))
                self.add_module(f"upfeat{lvl}", _deconv(ch, gen))
        ch = ND + LEVEL_EXTRA[2] + DD[4]
        for i, (oc, d) in enumerate(zip((128, 128, 128, 96, 64, 32),
                                        DILATIONS)):
            self.add_module(f"dc_conv{i + 1}",
                            nn.Sequential(_conv(ch, oc, gen, dilation=d)))
            ch = oc
        self.dc_conv7 = _conv(32, 2, gen)

    def _conv_lrelu(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(getattr(self, name)(x), 0.1)

    def features(self, im: torch.Tensor) -> Dict[int, torch.Tensor]:
        """The pyramid: level → the output of conv{level}b."""
        feats = {}
        x = im
        for name, _ic, _oc, _s in FEATURE_SPECS:
            x = self._conv_lrelu(name, x)
            if name.endswith("b"):
                feats[int(name[4])] = x
        return feats

    def _decoder_level(self, lvl: int, x: torch.Tensor):
        for i in range(5):
            x = torch.cat([self._conv_lrelu(f"conv{lvl}_{i}", x), x], 1)
        return x, getattr(self, f"predict_flow{lvl}")(x)

    def decode(self, f1: Dict[int, torch.Tensor],
               f2: Dict[int, torch.Tensor]) -> torch.Tensor:
        """Flow from frame 1 to frame 2 given both pyramids."""
        corr = F.leaky_relu(correlation(f1[6], f2[6]), 0.1)
        x, flow = self._decoder_level(6, corr)
        for lvl in (5, 4, 3, 2):
            up_flow = getattr(self, f"deconv{lvl + 1}")(flow)
            up_feat = getattr(self, f"upfeat{lvl + 1}")(x)
            warped = warp_masked(f2[lvl], up_flow * FLOW_SCALE[lvl])
            corr = F.leaky_relu(correlation(f1[lvl], warped), 0.1)
            x, flow = self._decoder_level(
                lvl, torch.cat([corr, f1[lvl], up_flow, up_feat], 1))
        h = x
        for i in range(6):
            h = self._conv_lrelu(f"dc_conv{i + 1}", h)
        return flow + self.dc_conv7(h)

    def forward(self, im1: torch.Tensor, im2: torch.Tensor) -> torch.Tensor:
        return self.decode(self.features(im1), self.features(im2))
