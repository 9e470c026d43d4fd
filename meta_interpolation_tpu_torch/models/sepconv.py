"""SepConv — adaptive separable convolution frame interpolation.

Counterpart of ``meta_interpolation_tpu/models/sepconv.py``: a 5-level
conv encoder-decoder (32→512 channels, triple-conv blocks, avg-pool down,
bilinear up with skip adds) feeding four subnets that emit per-pixel
51-tap vertical/horizontal kernels for each input frame. The output is
sepconv(pad₂₅(I0), kv1, kh1) + sepconv(pad₂₅(I1), kv2, kh2), computed by
the CUDA kernels of ``ops/sepconv.py`` on the card.

Submodule names follow the reference ``.pth`` (``moduleConv1.0``,
``moduleUpsample5.1``, ``moduleVertical1.7``, …), so its state dicts load
directly and JAX parameter trees bridge by name.

Padding protocol (JAX ``models/sepconv.py:111-118``): replicate-pad 25 px,
grow to the next ×128 on the bottom/right, crop back after.

In a row shard (``parallel/spatial.row_shard``, the exact
``--spatial_shards`` evaluation) every rank pads the whole frames, takes
its band of the grid's rows, runs the encoder-decoder and the subnets on
it (row-aware convs and upsamples, ``models/layers.py``) and the sepconv
op on its band: rows [r0, r0 + rows + 50) of the whole padded frame, with
the band's own kernel maps. The bands are gathered before the crop.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..ops import sepconv as sepconv_op
from ..parallel import spatial
from . import layers

PAD = 25
F_TAPS = 51
# the encoder pools five times: a band's rows are a multiple of 2**5
POOLS = 5
# subnets the reference calls without the adapted params, so they are
# left out of inner-loop adaptation (they stay outer-trainable)
INNER_FROZEN = ("moduleVertical1", "moduleVertical2",
                "moduleHorizontal1", "moduleHorizontal2")


def _basic(in_ch, out_ch, gen) -> nn.Sequential:
    return nn.Sequential(layers.conv3x3(in_ch, out_ch, gen), nn.ReLU(),
                         layers.conv3x3(out_ch, out_ch, gen), nn.ReLU(),
                         layers.conv3x3(out_ch, out_ch, gen), nn.ReLU())


def _upsample(ch, gen) -> nn.Sequential:
    return nn.Sequential(layers.Upsample(2, align_corners=True),
                         layers.conv3x3(ch, ch, gen), nn.ReLU())


def _subnet(gen) -> nn.Sequential:
    return nn.Sequential(layers.conv3x3(64, 64, gen), nn.ReLU(),
                         layers.conv3x3(64, 64, gen), nn.ReLU(),
                         layers.conv3x3(64, F_TAPS, gen), nn.ReLU(),
                         layers.Upsample(2, align_corners=True),
                         layers.conv3x3(F_TAPS, F_TAPS, gen))


class SepConv(nn.Module):
    """``forward(frame0, frame1)``: NCHW frames in [0, 1] → the middle
    frame, NCHW."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator
        for name, ic, oc in [("moduleConv1", 6, 32), ("moduleConv2", 32, 64),
                             ("moduleConv3", 64, 128),
                             ("moduleConv4", 128, 256),
                             ("moduleConv5", 256, 512),
                             ("moduleDeconv5", 512, 512),
                             ("moduleDeconv4", 512, 256),
                             ("moduleDeconv3", 256, 128),
                             ("moduleDeconv2", 128, 64)]:
            self.add_module(name, _basic(ic, oc, gen))
        for name, ch in [("moduleUpsample5", 512), ("moduleUpsample4", 256),
                         ("moduleUpsample3", 128), ("moduleUpsample2", 64)]:
            self.add_module(name, _upsample(ch, gen))
        for name in ("moduleVertical1", "moduleVertical2",
                     "moduleHorizontal1", "moduleHorizontal2"):
            self.add_module(name, _subnet(gen))

    @staticmethod
    def grid_rows(h: int) -> int:
        """The rows of the padded ×128 grid of a frame of ``h`` rows."""
        return -(-(h + 2 * PAD) // 128) * 128

    def row_bands(self, h: int, shards: int) -> bool:
        """Whether a frame of ``h`` rows runs exactly in ``shards`` row
        bands: its grid splits into equal bands whose rows every pool
        halves evenly."""
        return self.grid_rows(h) % (shards * 2 ** POOLS) == 0

    def forward(self, frame0: torch.Tensor, frame1: torch.Tensor
                ) -> torch.Tensor:
        layers.full_float32()
        h, w = frame0.shape[2], frame0.shape[3]
        # left/top get exactly PAD, bottom/right absorb the rounding
        target_h = self.grid_rows(h)
        target_w = -(-(w + 2 * PAD) // 128) * 128
        pads = (PAD, target_w - PAD - w, PAD, target_h - PAD - h)
        x0 = layers.replicate_pad(frame0, pads)
        x1 = layers.replicate_pad(frame1, pads)

        shard = spatial.current()
        inp = torch.cat([x0, x1], 1)
        c1 = self.moduleConv1(inp if shard is None
                              else spatial.band(inp, shard))
        c2 = self.moduleConv2(layers.avg_pool(c1))
        c3 = self.moduleConv3(layers.avg_pool(c2))
        c4 = self.moduleConv4(layers.avg_pool(c3))
        c5 = self.moduleConv5(layers.avg_pool(c4))

        d5 = self.moduleDeconv5(layers.avg_pool(c5))
        comb = self.moduleUpsample5(d5) + c5
        d4 = self.moduleDeconv4(comb)
        comb = self.moduleUpsample4(d4) + c4
        d3 = self.moduleDeconv3(comb)
        comb = self.moduleUpsample3(d3) + c3
        d2 = self.moduleDeconv2(comb)
        comb = self.moduleUpsample2(d2) + c2  # half resolution, 64 ch

        kv1 = self.moduleVertical1(comb)
        kv2 = self.moduleVertical2(comb)
        kh1 = self.moduleHorizontal1(comb)
        kh2 = self.moduleHorizontal2(comb)

        pad_k = F_TAPS // 2
        p0 = layers.replicate_pad(x0, pad_k)
        p1 = layers.replicate_pad(x1, pad_k)
        if shard is not None:
            # the band's taps reach 2·pad_k rows past it, in the whole
            # padded frame every rank holds
            r0, rows = shard.index * kv1.shape[2], kv1.shape[2]
            p0 = p0[:, :, r0:r0 + rows + 2 * pad_k]
            p1 = p1[:, :, r0:r0 + rows + 2 * pad_k]
        out = sepconv_op.sepconv(p0, kv1, kh1) + sepconv_op.sepconv(
            p1, kv2, kh2)
        if shard is not None:
            out = spatial.gather_band(out, shard)
        return out[:, :, PAD:PAD + h, PAD:PAD + w]


def inner_mask(model: nn.Module) -> Dict[str, bool]:
    """Parameter name → True where the inner loop adapts it: everything
    but the four kernel subnets (reference sepconv/model.py:346-347 calls
    them without the adapted params)."""
    return {name: name.split(".")[0] not in INNER_FROZEN
            for name, _ in model.named_parameters()}
