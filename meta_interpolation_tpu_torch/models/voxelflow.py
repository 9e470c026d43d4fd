"""Deep Voxel Flow (DVF).

Counterpart of ``meta_interpolation_tpu/models/voxelflow.py`` (reference
``voxelflow/core/models/voxel_flow.py:231-534``), in NCHW. A three-level
encoder of bias-free 5×5 / 5×5 / 3×3 convs, each followed by frozen batch
norm and ReLU and a 2×2 max pool; a bottleneck; a decoder of bilinear ×2
upsampling (align_corners=False), the skip concatenated, conv + BN + ReLU;
a 5×5 head under ``tanh``: 0.5·(its first two channels) is the voxel flow
in normalised grid units, the third the blend mask.

``syn_type='inter'`` samples the two frames at linspace ∓ flow through
``ops/warp.voxelflow_sample`` (border padding, align_corners=True): with
``warp_range`` > 0 the bounded sampler, kernels K3 / K3-grad on the card.
``'extra'`` samples both frames on one side (offsets −2, −1 of the flow)
through the same sampler, always exact. Inputs are (255·x − 127.5)/127.5
upstream (the registry) and reflect-padded to ×64.

Batch norm is frozen in every phase (reference :283-284, :352-355): a
fixed affine on stored statistics (``layers.EvalBatchNorm2d``), the
statistics buffers, so they are never meta-parameters. Conv weights are
N(0, 0.01), the head's bias zero. The per-step BN statistics of
``--per_step_bn_statistics`` are not ported.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..ops import warp as warp_ops
from . import layers

INIT_STD = 0.01
# (name, in, out, kernel) of each conv → BN → ReLU block
BLOCKS = (("conv1", 6, 64, 5), ("conv2", 64, 128, 5), ("conv3", 128, 256, 3),
          ("bottleneck", 256, 256, 3), ("deconv1", 512, 256, 3),
          ("deconv2", 384, 128, 5), ("deconv3", 192, 64, 5))


class VoxelFlow(nn.Module):
    """``forward(frame0, frame1)``: NCHW frames in [−1, 1] → the middle
    frame (``syn_type='inter'``) or the next one (``'extra'``), NCHW."""

    def __init__(self, generator: Optional[torch.Generator] = None,
                 warp_range: Optional[int] = None, syn_type: str = "inter"):
        super().__init__()
        if syn_type not in ("inter", "extra"):
            raise ValueError(f"syn_type is 'inter' or 'extra', got "
                             f"{syn_type!r}")
        for name, cin, cout, k in BLOCKS:
            setattr(self, name, layers.normal_init_(
                nn.Conv2d(cin, cout, k, padding=k // 2, bias=False),
                INIT_STD, generator))
            setattr(self, f"{name}_bn", layers.EvalBatchNorm2d(cout,
                                                               affine=True))
        self.conv4 = layers.normal_init_(nn.Conv2d(64, 3, 5, padding=2),
                                         INIT_STD, generator)
        self.warp_range = warp_range
        self.syn_type = syn_type

    def _cbr(self, name: str, x: torch.Tensor) -> torch.Tensor:
        bn = getattr(self, f"{name}_bn")
        return torch.relu(bn(getattr(self, name)(x)))

    def forward(self, frame0: torch.Tensor, frame1: torch.Tensor
                ) -> torch.Tensor:
        layers.full_float32()
        inp, pads = layers.pad_to_multiple(torch.cat([frame0, frame1], 1),
                                           64)
        conv1 = self._cbr("conv1", inp)
        conv2 = self._cbr("conv2", layers.max_pool(conv1, 2))
        conv3 = self._cbr("conv3", layers.max_pool(conv2, 2))
        x = self._cbr("bottleneck", layers.max_pool(conv3, 2))
        for name, skip in (("deconv1", conv3), ("deconv2", conv2),
                           ("deconv3", conv1)):
            x = layers.upsample_bilinear(x, 2, align_corners=False)
            x = self._cbr(name, torch.cat([x, skip], 1))
        x = torch.tanh(self.conv4(x))

        flow = 0.5 * x[:, 0:2].permute(0, 2, 3, 1)
        mask = x[:, 2:3]
        # extrapolation samples both frames on one side, exact (reference
        # :486-490)
        extra = self.syn_type == "extra"
        out = warp_ops.voxelflow_sample(
            inp[:, 0:3], inp[:, 3:6], flow, mask,
            warp_range=None if extra else self.warp_range,
            offsets=(-2.0, -1.0) if extra else (-1.0, 1.0))
        return layers.unpad(out, pads)


def inner_mask(model: nn.Module) -> Dict[str, bool]:
    """Parameter name → True where the inner loop adapts it: nothing of a
    ``*_bn`` layer (JAX ``inner_mask``, ``models/voxelflow.py:80-89``)."""
    return {name: not name.split(".")[0].endswith("_bn")
            for name, _ in model.named_parameters()}
