"""RRIN — Residue Refinement Interpolation Network.

Counterpart of ``meta_interpolation_tpu/models/rrin.py`` (reference
``rrin/model.py:61-151``), in NCHW. Four U-Nets:

  * ``Flow_L``      UNet(6→4, depth 5): flows between the two inputs;
  * ``refine_flow`` UNet(10→4, depth 4): refines the time-weighted flows;
  * ``Mask``        UNet(16→2, depth 4): soft occlusion weights;
  * ``final``       UNet(9→3, depth 4): residual refinement.

At t = 0.5: F_t0 = −(1−t)t·F01 + t²·F10, F_t1 = (1−t)²·F01 − t(1−t)·F10;
refine; backward-warp both inputs with RRIN's warp (``ops/warp.py``,
half-pixel quirk kept); blend with the sigmoid mask (ε = 1e-8); add the
``final`` residual; clamp to [0, 1]. Inputs are reflect-padded to ×128
and cropped back. ``warp_range`` > 0 takes the bounded warp, whose
accumulation is kernel K3 on the card; None or 0 the exact sampler.

In a row shard (``parallel/spatial.row_shard``, the exact
``--spatial_shards`` evaluation) every rank pads the whole frames, takes
its band of the ×128 grid's rows for the four U-Nets (row-aware convs and
upsamples, ``models/layers.py``), warps the whole padded frames at its
band's flows and rows, and gathers the bands of ``final``'s output before
the clamp and the crop.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..ops import warp as warp_ops
from ..parallel import spatial
from . import layers
from .unet import UNet

# the reference forward calls self.Mask without the adapted params
# (rrin/model.py:101), so the inner loop leaves it out
INNER_FROZEN = ("Mask",)
T = 0.5  # the middle frame


class RRIN(layers.PaddedGridBands, nn.Module):
    """``forward(frame0, frame1)``: NCHW frames in [0, 1] → the middle
    frame, NCHW."""

    MULTIPLE = 128  # the padded grid
    POOLS = 4  # Flow_L's average pools (depth 5)

    def __init__(self, generator: Optional[torch.Generator] = None,
                 warp_range: Optional[int] = None):
        super().__init__()
        gen = generator
        self.Mask = UNet(16, 2, 4, generator=gen)
        self.Flow_L = UNet(6, 4, 5, generator=gen)
        self.refine_flow = UNet(10, 4, 4, generator=gen)
        self.final = UNet(9, 3, 4, generator=gen)
        self.warp_range = warp_range

    def _warp(self, img: torch.Tensor, flow: torch.Tensor,
              row0: int = 0) -> torch.Tensor:
        return warp_ops.backward_warp_rrin(img, flow.permute(0, 2, 3, 1),
                                           warp_range=self.warp_range,
                                           row0=row0)

    def _process(self, x0: torch.Tensor, x1: torch.Tensor,
                 b0: torch.Tensor, b1: torch.Tensor, row0: int
                 ) -> torch.Tensor:
        """The blended warp of the whole padded frames ``x0``, ``x1`` at
        the rows of ``b0``, ``b1`` (theirs, or a band from ``row0``)."""
        t = T
        x = torch.cat([b0, b1], 1)
        flow = self.Flow_L(x)
        f01, f10 = flow[:, :2], flow[:, 2:4]
        ft0 = -(1 - t) * t * f01 + t * t * f10
        ft1 = (1 - t) * (1 - t) * f01 - t * (1 - t) * f10
        refined = self.refine_flow(torch.cat([ft0, ft1, x], 1))
        ft0 = ft0 + refined[:, :2]
        ft1 = ft1 + refined[:, 2:4]
        xt1 = self._warp(x0, ft0, row0)
        xt2 = self._warp(x1, ft1, row0)
        mask = torch.sigmoid(self.Mask(torch.cat([ft0, ft1, x, xt1, xt2], 1)))
        w1 = (1 - t) * mask[:, 0:1]
        w2 = t * mask[:, 1:2]
        return (w1 * xt1 + w2 * xt2) / (w1 + w2 + 1e-8)

    def forward(self, frame0: torch.Tensor, frame1: torch.Tensor
                ) -> torch.Tensor:
        layers.full_float32()
        x0, pads = layers.pad_to_multiple(frame0, self.MULTIPLE)
        x1, _ = layers.pad_to_multiple(frame1, self.MULTIPLE)
        shard = spatial.current()
        b0, b1, row0 = x0, x1, 0
        if shard is not None:
            b0, b1 = spatial.band(x0, shard), spatial.band(x1, shard)
            row0 = shard.index * b0.shape[2]
        output = self._process(x0, x1, b0, b1, row0)
        final = self.final(torch.cat([b0, b1, output], 1)) + output
        if shard is not None:
            final = spatial.gather_band(final, shard)
        return layers.unpad(final.clamp(0.0, 1.0), pads)


def inner_mask(model: nn.Module) -> Dict[str, bool]:
    """Parameter name → True where the inner loop adapts it: everything
    but the ``Mask`` U-Net."""
    return {name: name.split(".")[0] not in INNER_FROZEN
            for name, _ in model.named_parameters()}
