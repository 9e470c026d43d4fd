"""SuperSloMo — arbitrary-time flow interpolation.

Counterpart of ``meta_interpolation_tpu/models/superslomo.py`` (reference
``superslomo/model.py``), in NCHW. Two U-Nets:

  * ``flowComp``         UNet(6→4): the flows F_0_1 and F_1_0;
  * ``arbTimeFlowIntrp`` UNet(20→5): flow residuals and a visibility map.

A U-Net: two 7×7 convs (32 channels), five ``down`` blocks (2×2 average
pool, two convs of kernel 5, 3, 3, 3, 3; 64 → 512 channels), five ``up``
blocks (bilinear ×2 with align_corners=False, a 3×3 conv, the skip
concatenated, a 3×3 conv) and a 3×3 head; LeakyReLU(0.1) after every conv,
the head's included. Xavier-uniform weights, zero biases.

At t = 0.5 (index 3 of the reference's linspace(0.125, 0.875, 7)) the
time-weighted flows are F_t0 = −(1−t)t·F01 + t²·F10 and
F_t1 = (1−t)²·F01 − t(1−t)·F10. Six backward warps a forward use RRIN's
grid convention (``ops/warp.backward_warp_rrin``): with ``warp_range`` > 0
each is the bounded sampler, kernels K3 / K3-grad on the card; None or 0
the exact ``F.grid_sample``. Inputs are mean-subtracted upstream (the
registry) and reflect-padded to ×64. ``forward`` returns ``(pred, aux)``,
aux holding the flows and warped frames the ``Super`` loss reads
(``core/losses.py``).

In a row shard (``parallel/spatial.row_shard``, the exact
``--spatial_shards`` evaluation) every rank pads the whole frames and runs
both U-Nets on its band of the ×64 grid's rows (row-aware convs and
upsamples, ``models/layers.py``); all six warps sample the whole padded
frames at the band's flows and rows, so no warp reads a banded feature.
The prediction and every aux tensor are gathered before the crop: the
loss then runs on whole frames on every rank.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..ops import warp as warp_ops
from ..parallel import spatial
from . import layers

T = 0.5  # the middle frame
SLOPE = 0.1
DOWN_KERNELS = (5, 3, 3, 3, 3)


def _act(x: torch.Tensor) -> torch.Tensor:
    return layers.leaky_relu(x, SLOPE)


class Down(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, k: int,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = layers.xavier_conv(in_ch, out_ch, k, gen)
        self.conv2 = layers.xavier_conv(out_ch, out_ch, k, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = layers.avg_pool(x, 2)
        return _act(self.conv2(_act(self.conv1(x))))


class Up(nn.Module):
    def __init__(self, in_ch: int, out_ch: int,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = layers.xavier_conv(in_ch, out_ch, 3, gen)
        self.conv2 = layers.xavier_conv(2 * out_ch, out_ch, 3, gen)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        x = layers.upsample_bilinear(x, 2, align_corners=False)
        x = _act(self.conv1(x))
        return _act(self.conv2(torch.cat([x, skip], 1)))


class UNet(nn.Module):
    """SuperSloMo's U-Net (reference superslomo/model.py:457-544). Names
    are the JAX tree's: ``conv1``, ``conv2``, ``down1..5``, ``up1..5``,
    ``conv3``."""

    def __init__(self, in_ch: int, out_ch: int,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = layers.xavier_conv(in_ch, 32, 7, gen)
        self.conv2 = layers.xavier_conv(32, 32, 7, gen)
        widths = (32, 64, 128, 256, 512, 512)
        for i, k in enumerate(DOWN_KERNELS):
            setattr(self, f"down{i + 1}",
                    Down(widths[i], widths[i + 1], k, gen))
        for i, (cin, cout) in enumerate([(512, 512), (512, 256), (256, 128),
                                         (128, 64), (64, 32)]):
            setattr(self, f"up{i + 1}", Up(cin, cout, gen))
        self.conv3 = layers.xavier_conv(32, out_ch, 3, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _act(self.conv1(x))
        skips = [_act(self.conv2(x))]
        for i in range(1, 5):
            skips.append(getattr(self, f"down{i}")(skips[-1]))
        x = self.down5(skips[-1])
        for i, skip in enumerate(reversed(skips)):
            x = getattr(self, f"up{i + 1}")(x, skip)
        return _act(self.conv3(x))


class SuperSloMo(layers.PaddedGridBands, nn.Module):
    """``forward(frame0, frame1)``: NCHW frames, mean-subtracted → (the
    middle frame, NCHW; aux)."""

    MULTIPLE = 64  # the padded grid
    POOLS = 5  # a U-Net's average pools

    def __init__(self, generator: Optional[torch.Generator] = None,
                 warp_range: Optional[int] = None):
        super().__init__()
        self.flowComp = UNet(6, 4, generator)
        self.arbTimeFlowIntrp = UNet(20, 5, generator)
        self.warp_range = warp_range

    def _warp(self, img: torch.Tensor, flow: torch.Tensor,
              row0: int = 0) -> torch.Tensor:
        return warp_ops.backward_warp_rrin(img, flow.permute(0, 2, 3, 1),
                                           warp_range=self.warp_range,
                                           row0=row0)

    def forward(self, frame0: torch.Tensor, frame1: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, Tuple[torch.Tensor, ...]]]:
        layers.full_float32()
        t = T
        i0, pads = layers.pad_to_multiple(frame0, self.MULTIPLE)
        i1, _ = layers.pad_to_multiple(frame1, self.MULTIPLE)
        shard = spatial.current()
        b0, b1, row0 = i0, i1, 0
        if shard is not None:
            b0, b1 = spatial.band(i0, shard), spatial.band(i1, shard)
            row0 = shard.index * b0.shape[2]

        flow = self.flowComp(torch.cat([b0, b1], 1))
        f01, f10 = flow[:, :2], flow[:, 2:]
        c00 = c11 = -(1 - t) * t
        c01, c10 = t * t, (1 - t) * (1 - t)
        f_t0 = c00 * f01 + c01 * f10
        f_t1 = c10 * f01 + c11 * f10
        g_i0_t0 = self._warp(i0, f_t0, row0)
        g_i1_t1 = self._warp(i1, f_t1, row0)

        intrp = self.arbTimeFlowIntrp(torch.cat(
            [b0, b1, f01, f10, f_t1, f_t0, g_i1_t1, g_i0_t0], 1))
        f_t0_f = intrp[:, :2] + f_t0
        f_t1_f = intrp[:, 2:4] + f_t1
        v_t0 = torch.sigmoid(intrp[:, 4:5])
        v_t1 = 1.0 - v_t0
        g_i0_f = self._warp(i0, f_t0_f, row0)
        g_i1_f = self._warp(i1, f_t1_f, row0)
        w0, w1 = 1 - t, t
        pred = (w0 * v_t0 * g_i0_f + w1 * v_t1 * g_i1_f) / (
            w0 * v_t0 + w1 * v_t1)

        warped_i0 = self._warp(i0, f10, row0)
        warped_i1 = self._warp(i1, f01, row0)

        def unpad(*xs):
            # the whole frame's rows on every rank (the bands gathered)
            if shard is not None:
                xs = [spatial.gather_band(x, shard) for x in xs]
            return tuple(layers.unpad(x, pads) for x in xs)
        aux = {"bidirectional_flow": unpad(f01, f10),
               "warped_intermediate_frames": unpad(g_i0_t0, g_i1_t1),
               "warped_input_frames": unpad(warped_i0, warped_i1)}
        return unpad(pred)[0], aux
