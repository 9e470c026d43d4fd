"""DAIN — depth-aware frame interpolation, NCHW.

Counterpart of ``meta_interpolation_tpu/models/dain/model.py`` (reference
``networks/DAIN.py:423-846``, MetaDAIN), at timestep 0.5, in the same
order:

  1. reflect-pad both frames to ×64;
  2. log depth of both frames in one batch (``hourglass``); inverse depth
     1e-6 + exp(−log depth), clamped to [0, 1e8]; contexts: S2DF features
     with the detached log depth; filters: MonoNet5 on both frames;
  3. PWC-Net flows 0→2 and 2→0 (both directions as one batch), ×20×0.5,
     bilinearly upsampled ×4;
  4. the depth-weighted projection of both flows (``ops/flow_projection``;
     ``proj_range`` R takes kernel K4 on the card);
  5. filter interpolation of the contexts (detached offsets and filters)
     and of the frames; their mean is the coarse frame;
  6. the 437-channel rectify input, the rectify residual added to the
     coarse frame, and the crop back.

Only ``rectifyNet`` adapts in the inner loop and trains in the outer one
(:func:`inner_mask`, :func:`outer_mask`); every other subnet is frozen, so
no gradient reaches the projection.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from .. import layers
from ...ops.filter_interpolation import filter_interpolation
from ...ops.flow_projection import flow_projection
from . import hourglass, mononet, pwcnet, rectify, s2df

DIV_FLOW = 20.0
TIMESTEP = 0.5
CTX_CH = s2df.CTX_CHANNELS  # 195
# coarse(3) + ref0(3) + ref2(3) + off0(2) + off2(2) + filt0(16) + filt2(16)
# + 2 × (ctx 195 + log depth 1) = 437
RECTIFY_IN = 9 + 4 + 32 + 2 * (CTX_CH + 1)
PAD_MULTIPLE = 64
INNER_ADAPTED = ("rectifyNet",)


class DAIN(nn.Module):
    """``forward(frame0, frame1, proj_range=None, fill_holes=False)``:
    NCHW frames in [0, 1] → the middle frame, NCHW.

    ``proj_range``: None projects exactly (plain scatter); R takes the
    bounded projection, kernel K4 on a CUDA tensor, exact for flows within
    R pixels. ``fill_holes``: fill the projections' holes, as the
    reference does whenever the flow needs no gradient (every forward of
    the meta system). Convolutions run in full float32, TF32 off."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator
        self.depthNet = hourglass.build(gen)
        self.ctxNet = s2df.S2DF(gen)
        self.initScaleNets_filter = mononet.Trunk(gen)
        self.initScaleNets_filter1 = mononet.Branch(generator=gen)
        self.initScaleNets_filter2 = mononet.Branch(generator=gen)
        self.flownets = pwcnet.PWCNet(gen)
        self.rectifyNet = rectify.Rectify(RECTIFY_IN, generator=gen)

    def flows(self, x0: torch.Tensor, x2: torch.Tensor):
        """(flow 0→2, flow 2→0), each (N, 2, H, W) at t = 0.5, from padded
        frames: one feature pyramid of both frames, both directions decoded
        as one batch."""
        n = x0.shape[0]
        f = self.flownets.features(torch.cat([x0, x2]))
        swapped = {k: torch.cat([v[n:], v[:n]]) for k, v in f.items()}
        flow = self.flownets.decode(f, swapped) * (DIV_FLOW * TIMESTEP)
        flow = layers.resize_bilinear(flow, (flow.shape[2] * 4,
                                             flow.shape[3] * 4))
        return flow[:n], flow[n:]

    def forward(self, frame0: torch.Tensor, frame1: torch.Tensor,
                proj_range: Optional[int] = None,
                fill_holes: bool = False) -> torch.Tensor:
        rect_in, coarse, pads = self.rectify_input(frame0, frame1,
                                                   proj_range, fill_holes)
        out = self.rectifyNet(rect_in) + coarse
        return layers.unpad(out, pads)

    def rectify_input(self, frame0: torch.Tensor, frame1: torch.Tensor,
                      proj_range: Optional[int] = None,
                      fill_holes: bool = False):
        """Steps 1–5 and the rectify input of step 6: (the 437-channel
        rectify input, the coarse frame, the pads), every value from the
        subnets that meta-training freezes."""
        layers.full_float32()
        x0, pads = layers.pad_to_multiple(frame0, PAD_MULTIPLE)
        x2, _ = layers.pad_to_multiple(frame1, PAD_MULTIPLE)
        n = x0.shape[0]

        log_depth = self.depthNet(torch.cat([x0, x2]))
        ld0, ld2 = log_depth[:n], log_depth[n:]
        ctx0 = torch.cat([self.ctxNet(x0), ld0.detach()], 1)
        ctx2 = torch.cat([self.ctxNet(x2), ld2.detach()], 1)
        temp = self.initScaleNets_filter(torch.cat([x0, x2], 1))
        filt0 = self.initScaleNets_filter1(temp)
        filt2 = self.initScaleNets_filter2(temp)
        # the clamp keeps exp finite with untrained depth weights
        depth_inv0 = (1e-6 + torch.exp(-ld0)).clamp(0.0, 1e8)
        depth_inv2 = (1e-6 + torch.exp(-ld2)).clamp(0.0, 1e8)

        flow_02, flow_20 = self.flows(x0, x2)
        nhwc = lambda t: t.permute(0, 2, 3, 1)
        # offsets stay (N, H, W, 2), the layout the ops take
        off0 = flow_projection(nhwc(flow_02), nhwc(depth_inv0),
                               fill_hole=fill_holes, proj_range=proj_range)
        off2 = flow_projection(nhwc(flow_20), nhwc(depth_inv2),
                               fill_hole=fill_holes, proj_range=proj_range)

        ctx0_w = filter_interpolation(ctx0, off0.detach(), filt0.detach())
        ctx2_w = filter_interpolation(ctx2, off2.detach(), filt2.detach())
        ref0 = filter_interpolation(x0, off0, filt0)
        ref2 = filter_interpolation(x2, off2, filt2)
        coarse = ref0 / 2.0 + ref2 / 2.0

        nchw = lambda t: t.permute(0, 3, 1, 2)
        rect_in = torch.cat([coarse, ref0, ref2, nchw(off0), nchw(off2),
                             filt0, filt2, ctx0_w, ctx2_w], 1)
        return rect_in, coarse, pads


def tame_depth_head_(model: DAIN) -> DAIN:
    """Scale the depth net's last conv by 1e-4 and zero its bias, in place.
    Random-init log depth grows without bound through the hourglass and
    overflows the inverse depth; the JAX package's DAIN tests tame it the
    same way (tests/test_dain_model.py:99-105). Released weights need no
    taming."""
    head = model.depthNet[-1]
    with torch.no_grad():
        head.weight.mul_(1e-4)
        head.bias.zero_()
    return model


def inner_mask(model: nn.Module) -> Dict[str, bool]:
    """Parameter name → True where the inner loop adapts it: rectifyNet
    only (reference meta_learning_system.py:96-101)."""
    return {name: name.split(".")[0] in INNER_ADAPTED
            for name, _ in model.named_parameters()}


def outer_mask(model: nn.Module) -> Dict[str, bool]:
    """Parameter name → True where the outer optimizer trains it:
    rectifyNet only, as the inner loop (JAX ``outer_mask``,
    ``models/dain/model.py:74-80``: the reference sets requires_grad=False
    on every other subnet). The frozen subnets are off the tape in both
    loops."""
    return inner_mask(model)


def charbonnier_loss(pred: torch.Tensor, target: torch.Tensor,
                     epsilon: float = 1e-8) -> torch.Tensor:
    """DAIN's training loss (reference loss_function.py:14-24, eps 1e-8 at
    DAIN.py:638)."""
    return torch.mean(torch.sqrt((pred - target) ** 2 + epsilon))
