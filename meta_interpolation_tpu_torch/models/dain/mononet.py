"""MonoNet5 — DAIN's filter-kernel encoder-decoder, NCHW.

Counterpart of ``meta_interpolation_tpu/models/dain/mononet.py`` (reference
``networks/DAIN.py:662-739``): a 5-level conv/ReLU/max-pool encoder
(16→512), an intermediate conv, and a 5-level bilinear-upsample decoder
that adds the matching pre-pool encoder feature after each upsample; two
conv-ReLU-conv branches emit the 16-channel 4×4 filter maps of each frame.

Conv names are the indices of the reference's flat layer list ([conv,
relu] takes two, a pool or an upsample one: convs at 0, 2, 5, 8, …; the
branches' at 0 and 2), so weights join by name. Init: xavier-uniform,
zero bias (``layers.conv3x3``).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import layers

# (kind, in, out): kind ∈ conv (3×3 conv + relu), pool, up
TRUNK: List[Tuple[str, int, int]] = [
    ("conv", 6, 16),
    ("conv", 16, 32), ("pool", 0, 0),
    ("conv", 32, 64), ("pool", 0, 0),
    ("conv", 64, 128), ("pool", 0, 0),
    ("conv", 128, 256), ("pool", 0, 0),
    ("conv", 256, 512), ("pool", 0, 0),
    ("conv", 512, 512),
    ("up", 0, 0), ("conv", 512, 256),
    ("up", 0, 0), ("conv", 256, 128),
    ("up", 0, 0), ("conv", 128, 64),
    ("up", 0, 0), ("conv", 64, 32),
    ("up", 0, 0), ("conv", 32, 16),
]


class Trunk(nn.Module):
    """(N, 6, H, W) → (N, 16, H, W); H and W divisible by 32."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        idx = 0
        for kind, ic, oc in TRUNK:
            if kind == "conv":
                self.add_module(str(idx), layers.conv3x3(ic, oc, generator))
                idx += 2
            else:
                idx += 1

    def forward(self, x):
        stack = []
        idx = 0
        for kind, _ic, _oc in TRUNK:
            if kind == "conv":
                x = F.relu(getattr(self, str(idx))(x))
                idx += 2
            elif kind == "pool":
                stack.append(x)
                x = layers.max_pool(x, 2)
                idx += 1
            else:
                x = layers.upsample_bilinear(x, 2) + stack.pop()
                idx += 1
        return x


class Branch(nn.Module):
    """conv-ReLU-conv: (N, 16, H, W) → (N, channel_out, H, W)."""

    def __init__(self, channel_out: int = 16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.add_module("0", layers.conv3x3(16, 16, generator))
        self.add_module("2", layers.conv3x3(16, channel_out, generator))

    def forward(self, x):
        return getattr(self, "2")(F.relu(getattr(self, "0")(x)))
