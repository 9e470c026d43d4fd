"""Bilinear grid sampling and backward warping.

Counterpart of ``meta_interpolation_tpu/ops/warp.py``. Images are NCHW;
grids and flows are channel-last (N, H, W, 2), as ``F.grid_sample`` takes
them, with grid (x, y) in [−1, 1] and flow (u = dx, v = dy) in pixels.

  * :func:`grid_sample` — the exact sampler, ``F.grid_sample(mode=
    'bilinear')`` (the JAX package computes it with one XLA gather, outside
    any TPU kernel).
  * :func:`grid_sample_bounded` — exact for samples within R pixels of
    their output location, clamped beyond: the fast path of
    ``--fast_warp_range``. On the card the whole sampler is one kernel
    each way, grid in: K3 for the output, K3-grad for the grid gradient
    (``ops/warp_bounded.py``, ``csrc/warp.cu``).
  * :func:`sample` dispatches between the two; :func:`backward_warp` and
    :func:`backward_warp_rrin` (RRIN's half-pixel quirk ``2·(x/W − 0.5)``)
    build the grid from a flow.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import warp_bounded
from .warp_bounded import _compute_dtype


def grid_sample(img: torch.Tensor, grid: torch.Tensor,
                align_corners: bool = False,
                padding_mode: str = "zeros") -> torch.Tensor:
    """Exact bilinear sampling. img (N, C, H, W); grid (N, Ho, Wo, 2)."""
    return F.grid_sample(img, grid.to(img.dtype), mode="bilinear",
                         padding_mode=padding_mode,
                         align_corners=align_corners)


def grid_sample_bounded(img: torch.Tensor, grid: torch.Tensor,
                        max_displacement: int, align_corners: bool = False,
                        padding_mode: str = "zeros") -> torch.Tensor:
    """Bilinear sampling exact for displacements (per axis) in [−R, R−1]
    from the output pixel and clamped to that window beyond. The grid must
    have the image's H×W. Out-of-image samples follow ``padding_mode``
    ('zeros' or 'border'). One kernel launch each way on the card
    (``ops/warp_bounded.py``); the plain composition on the CPU."""
    if padding_mode not in warp_bounded.PADDING_MODES:
        raise ValueError(f"the bounded sampler takes padding "
                         f"{warp_bounded.PADDING_MODES}, got {padding_mode!r}")
    return warp_bounded.GridSampleBoundedFunction.apply(
        img, grid, int(max_displacement), align_corners, padding_mode)


def sample(img: torch.Tensor, grid: torch.Tensor, align_corners: bool,
           padding_mode: str, warp_range: Optional[int] = None
           ) -> torch.Tensor:
    """Exact sampler (``warp_range`` None or 0) or the bounded fast path."""
    if warp_range:
        return grid_sample_bounded(img, grid, int(warp_range),
                                   align_corners=align_corners,
                                   padding_mode=padding_mode)
    return grid_sample(img, grid, align_corners=align_corners,
                       padding_mode=padding_mode)


def _pixel_grid(img: torch.Tensor, flow: torch.Tensor):
    """(x + u, y + v), each (N, H, W), in the compute dtype."""
    h, w = img.shape[2], img.shape[3]
    ct = _compute_dtype(flow.dtype)
    xs = torch.arange(w, dtype=ct, device=flow.device)[None, None, :]
    ys = torch.arange(h, dtype=ct, device=flow.device)[None, :, None]
    return xs + flow[..., 0].to(ct), ys + flow[..., 1].to(ct)


def backward_warp(img: torch.Tensor, flow: torch.Tensor,
                  align_corners: bool = False, padding_mode: str = "zeros",
                  warp_range: Optional[int] = None) -> torch.Tensor:
    """out(y, x) = img(y + v, x + u); flow (N, H, W, 2) in pixels."""
    h, w = img.shape[2], img.shape[3]
    ix, iy = _pixel_grid(img, flow)
    if align_corners:
        gx, gy = 2.0 * ix / (w - 1) - 1.0, 2.0 * iy / (h - 1) - 1.0
    else:
        gx, gy = (2.0 * ix + 1.0) / w - 1.0, (2.0 * iy + 1.0) / h - 1.0
    return sample(img, torch.stack([gx, gy], dim=-1),
                  align_corners=align_corners, padding_mode=padding_mode,
                  warp_range=warp_range)


def backward_warp_rrin(img: torch.Tensor, flow: torch.Tensor,
                       warp_range: Optional[int] = None) -> torch.Tensor:
    """RRIN's warp (reference rrin/model.py:8-21): the grid is normalised
    as ``2·(pos/size − 0.5)`` with align_corners=False, so the sample lands
    at ``pos − 0.5``; the quirk is kept for weight parity."""
    h, w = img.shape[2], img.shape[3]
    x, y = _pixel_grid(img, flow)
    gx, gy = 2.0 * (x / w - 0.5), 2.0 * (y / h - 0.5)
    return sample(img, torch.stack([gx, gy], dim=-1), align_corners=False,
                  padding_mode="zeros", warp_range=warp_range)
