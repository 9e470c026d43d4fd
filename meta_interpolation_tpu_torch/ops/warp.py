"""Bilinear grid sampling and backward warping.

Counterpart of ``meta_interpolation_tpu/ops/warp.py``. Images are NCHW;
grids and flows are channel-last (N, H, W, 2), as ``F.grid_sample`` takes
them, with grid (x, y) in [−1, 1] and flow (u = dx, v = dy) in pixels.

  * :func:`grid_sample` — the exact sampler, ``F.grid_sample(mode=
    'bilinear')`` (the JAX package computes it with one XLA gather, outside
    any TPU kernel).
  * :func:`grid_sample_bounded` — exact for samples within R pixels of
    their output location, clamped beyond: the fast path of
    ``--fast_warp_range``. The coordinate math and the zero-padding mass
    rescale are plain PyTorch here; the accumulation is kernel K3
    (``ops/warp_bounded.py``, ``csrc/warp.cu``).
  * :func:`sample` dispatches between the two; :func:`backward_warp` and
    :func:`backward_warp_rrin` (RRIN's half-pixel quirk ``2·(x/W − 0.5)``)
    build the grid from a flow.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .warp_bounded import warp_bounded


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """Index and weight math runs at float32 or wider."""
    return torch.promote_types(dtype, torch.float32)


def _unnormalize(grid: torch.Tensor, h: int, w: int, align_corners: bool):
    """grid (N, Ho, Wo, 2) → pixel coordinates (ix, iy), each (N, Ho, Wo)."""
    ct = _compute_dtype(grid.dtype)
    gx, gy = grid[..., 0].to(ct), grid[..., 1].to(ct)
    if align_corners:
        return (gx + 1.0) * 0.5 * (w - 1), (gy + 1.0) * 0.5 * (h - 1)
    return ((gx + 1.0) * w - 1.0) * 0.5, ((gy + 1.0) * h - 1.0) * 0.5


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
    have the image's H×W. Out-of-image samples follow ``padding_mode``:
    edge clamping is 'border'; the in-bounds bilinear mass and a validity
    mask reproduce 'zeros'."""
    n, c, h, w = img.shape
    ix, iy = _unnormalize(grid, h, w, align_corners)
    ct = ix.dtype
    if padding_mode == "border":
        ix = ix.clamp(0.0, w - 1)
        iy = iy.clamp(0.0, h - 1)
    else:
        # zeros: samples whose 2×2 support is wholly outside read 0
        inb = (ix > -1.0) & (ix < w) & (iy > -1.0) & (iy < h)

    xs = torch.arange(w, dtype=ct, device=img.device)[None, None, :]
    ys = torch.arange(h, dtype=ct, device=img.device)[None, :, None]
    r = int(max_displacement)
    dy = (iy - ys).clamp(-r, r - 1)
    dx = (ix - xs).clamp(-r, r - 1)
    dy0f, dx0f = torch.floor(dy), torch.floor(dx)
    fy = (dy - dy0f).to(img.dtype)
    fx = (dx - dx0f).to(img.dtype)
    out = warp_bounded(img, dy0f.to(torch.int32), dx0f.to(torch.int32),
                       fy, fx, r)

    if padding_mode != "border":
        # zero padding: re-weight by the in-bounds bilinear mass
        ix0, iy0 = torch.floor(ix), torch.floor(iy)
        wx1, wy1 = ix - ix0, iy - iy0
        wx0, wy0 = 1 - wx1, 1 - wy1
        mx0 = ((ix0 >= 0) & (ix0 <= w - 1)).to(ct)
        mx1 = ((ix0 + 1 >= 0) & (ix0 + 1 <= w - 1)).to(ct)
        my0 = ((iy0 >= 0) & (iy0 <= h - 1)).to(ct)
        my1 = ((iy0 + 1 >= 0) & (iy0 + 1 <= h - 1)).to(ct)
        mass = (wy0 * my0 + wy1 * my1) * (wx0 * mx0 + wx1 * mx1)
        out = out * mass.to(out.dtype)[:, None]
        out = torch.where(inb[:, None], out, 0.0)
    return out


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
