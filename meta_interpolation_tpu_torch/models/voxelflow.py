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
N(0, 0.01), the head's bias zero.

``--per_step_bn_statistics`` (JAX ``models/voxelflow.py:108-215``) calls
the forward with ``bn_state`` (:func:`init_bn_state`, per-step running
rows (S, C) for each BN, a group of the meta-parameters beside the net)
and ``num_step``: each BN normalises with the batch's statistics and
updates row ``num_step`` (``layers.meta_batch_norm``), and the forward
returns ``(pred, new_bn_state)``. Built with ``per_step_bn_affine=S``, the
BN scale and bias are per-step rows (S, C) too, row ``num_step`` applied
(the reference's combination without
``--enable_inner_loop_optimizable_bn_params``); otherwise the flat affine
goes with the per-step statistics.

In a row shard (``parallel/spatial.row_shard``, the exact
``--spatial_shards`` evaluation) every rank pads the whole frames and runs
the net on its band of the ×64 grid's rows (row-aware convs through
``layers.conv_as_input`` and upsamples; the max pools and the frozen BN
are local); the head's flow and mask are the band's, and
``voxelflow_sample`` samples the whole padded frames at the band's rows.
The bands of the output are gathered before the crop. The per-step BN
(``bn_state``), whose batch statistics span the frame, is not banded.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..ops import warp as warp_ops
from ..parallel import spatial
from . import layers

INIT_STD = 0.01
# (name, in, out, kernel) of each conv → BN → ReLU block
BLOCKS = (("conv1", 6, 64, 5), ("conv2", 64, 128, 5), ("conv3", 128, 256, 3),
          ("bottleneck", 256, 256, 3), ("deconv1", 512, 256, 3),
          ("deconv2", 384, 128, 5), ("deconv3", 192, 64, 5))


class VoxelFlow(layers.PaddedGridBands, nn.Module):
    """``forward(frame0, frame1)``: NCHW frames in [−1, 1] → the middle
    frame (``syn_type='inter'``) or the next one (``'extra'``), NCHW."""

    MULTIPLE = 64  # the padded grid
    POOLS = 3  # the encoder's max pools

    def __init__(self, generator: Optional[torch.Generator] = None,
                 warp_range: Optional[int] = None, syn_type: str = "inter",
                 per_step_bn_affine: int = 0):
        super().__init__()
        if syn_type not in ("inter", "extra"):
            raise ValueError(f"syn_type is 'inter' or 'extra', got "
                             f"{syn_type!r}")
        for name, cin, cout, k in BLOCKS:
            setattr(self, name, layers.normal_init_(
                nn.Conv2d(cin, cout, k, padding=k // 2, bias=False),
                INIT_STD, generator))
            bn = layers.EvalBatchNorm2d(cout, affine=True)
            if per_step_bn_affine > 0:
                # per-step affine rows (JAX init(per_step_bn_affine=S)):
                # the per-step BN path alone reads them
                bn.weight = nn.Parameter(torch.ones(per_step_bn_affine,
                                                    cout))
                bn.bias = nn.Parameter(torch.zeros(per_step_bn_affine, cout))
            setattr(self, f"{name}_bn", bn)
        self.conv4 = layers.normal_init_(nn.Conv2d(64, 3, 5, padding=2),
                                         INIT_STD, generator)
        self.warp_range = warp_range
        self.syn_type = syn_type

    def _cbr(self, name: str, x: torch.Tensor, bn_state, new_state,
             num_step: int) -> torch.Tensor:
        """conv → BN → ReLU: the frozen BN without ``bn_state``, else the
        per-step meta BN, its updated rows put in ``new_state`` (JAX
        ``_cbr``, ``models/voxelflow.py:121-146``)."""
        bn = getattr(self, f"{name}_bn")
        x = layers.conv_as_input(getattr(self, name), x)
        if bn_state is None:
            return torch.relu(bn(x))
        w, b = bn.weight, bn.bias
        if w.ndim == 2:
            w, b = w[num_step], b[num_step]
        key = f"{name}_bn."
        x, (mean, var) = layers.meta_batch_norm(
            x, w, b, bn_state[key + "running_mean"],
            bn_state[key + "running_var"], num_step=num_step)
        new_state[key + "running_mean"] = mean
        new_state[key + "running_var"] = var
        return torch.relu(x)

    def forward(self, frame0: torch.Tensor, frame1: torch.Tensor,
                bn_state: Optional[Dict[str, torch.Tensor]] = None,
                num_step: int = 0):
        """The prediction; given ``bn_state``, ``(pred, new_bn_state)``
        with ``num_step`` clipped to the state's rows."""
        layers.full_float32()
        inp, pads = layers.pad_to_multiple(torch.cat([frame0, frame1], 1),
                                           self.MULTIPLE)
        shard = spatial.current()
        x, row0 = inp, 0
        if shard is not None:
            if bn_state is not None:
                raise NotImplementedError(
                    "VoxelFlow's per-step batch norm on row bands")
            x = spatial.band(inp, shard)
            row0 = shard.index * x.shape[2]
        new_state: Dict[str, torch.Tensor] = {}
        if bn_state is not None:
            rows = bn_state["conv1_bn.running_mean"].shape[0]
            num_step = min(max(int(num_step), 0), rows - 1)

        def cbr(name, x):
            return self._cbr(name, x, bn_state, new_state, num_step)

        conv1 = cbr("conv1", x)
        conv2 = cbr("conv2", layers.max_pool(conv1, 2))
        conv3 = cbr("conv3", layers.max_pool(conv2, 2))
        x = cbr("bottleneck", layers.max_pool(conv3, 2))
        for name, skip in (("deconv1", conv3), ("deconv2", conv2),
                           ("deconv3", conv1)):
            x = layers.upsample_bilinear(x, 2, align_corners=False)
            x = cbr(name, torch.cat([x, skip], 1))
        x = torch.tanh(layers.conv_as_input(self.conv4, x))

        flow = 0.5 * x[:, 0:2].permute(0, 2, 3, 1)
        mask = x[:, 2:3]
        # extrapolation samples both frames on one side, exact (reference
        # :486-490)
        extra = self.syn_type == "extra"
        out = warp_ops.voxelflow_sample(
            inp[:, 0:3], inp[:, 3:6], flow, mask,
            warp_range=None if extra else self.warp_range,
            offsets=(-2.0, -1.0) if extra else (-1.0, 1.0), row0=row0)
        if shard is not None:
            out = spatial.gather_band(out, shard)
        out = layers.unpad(out, pads)
        return out if bn_state is None else (out, new_state)


def init_bn_state(num_steps: int, device=None) -> Dict[str, torch.Tensor]:
    """Per-step BN running statistics of every BN, rows (num_steps, C) of
    zero means and unit variances (JAX ``init_bn_state``,
    ``models/voxelflow.py:108-118``: the reference layer's own init, not
    the flat statistics), named ``<bn>.running_mean`` / ``.running_var``."""
    state = {}
    for name, _, cout, _ in BLOCKS:
        mean, var = layers.meta_batch_norm_init(cout, num_steps,
                                                device=device)
        state[f"{name}_bn.running_mean"] = mean
        state[f"{name}_bn.running_var"] = var
    return state


def inner_mask(model: nn.Module) -> Dict[str, bool]:
    """Parameter name → True where the inner loop adapts it: nothing of a
    ``*_bn`` layer (JAX ``inner_mask``, ``models/voxelflow.py:80-89``)."""
    return {name: not name.split(".")[0].endswith("_bn")
            for name, _ in model.named_parameters()}
