"""Bilinear grid sampling and backward warping.

Counterpart of ``meta_interpolation_tpu/ops/warp.py``. Images are NCHW;
grids and flows are channel-last (N, H, W, 2), as ``F.grid_sample`` takes
them, with grid (x, y) in [−1, 1] and flow (u = dx, v = dy) in pixels.

  * :func:`grid_sample` — the exact sampler, ``F.grid_sample(mode=
    'bilinear')`` (the JAX package computes it with one XLA gather, outside
    any TPU kernel). Its first derivative is aten's
    ``grid_sampler_2d_backward``, as ``F.grid_sample``'s own; the
    derivative of that is autograd through the plain closed form of the
    sampler's gradients (:func:`grid_sample_grads_ref`), which the JAX
    package gets by differentiating its gather twice, so second-order
    training runs on the exact sampler on any build of PyTorch.
  * :func:`grid_sample_bounded` — exact for samples within R pixels of
    their output location, clamped beyond: the fast path of
    ``--fast_warp_range``. On the card the whole sampler is one kernel
    each way, grid in: K3 for the output, K3-grad for the grid gradient
    and, in second order, K3-grad² for that gradient's derivative
    (``ops/warp_bounded.py``, ``csrc/warp.cu``).
  * :func:`sample` dispatches between the two; :func:`backward_warp` and
    :func:`backward_warp_rrin` (RRIN's and SuperSloMo's half-pixel quirk
    ``2·(x/W − 0.5)``) build the grid from a flow, and
    :func:`voxelflow_sample` is VoxelFlow's symmetric two-frame sampler
    (border padding, align_corners=True).
  * :class:`FlowStats` records the displacements the exact sampler sees.

Row bands (the row-sharded evaluation, ``--spatial_shards``): given a
flow of a band of output rows and ``row0``, the band's first global row,
each function samples the whole image at those rows: the pixel grid's
rows are ``row0 + arange(rows)``, normalised by the whole image's H, and
the bounded sampler measures each displacement from its global row.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import warp_bounded
from .warp_bounded import _compute_dtype


class FlowStats:
    """Record the pixel displacements the exact sampler sees (JAX
    ``ops/warp.py:83-158``): the measured ground truth for choosing
    ``warp_range`` (the bounded sampler is exact for per-axis displacements
    in [−R, R−1] and clamps beyond).

        with warp.FlowStats(r=8) as fs:
            model(f0, f1)                      # warp_range None
        fs.frac_beyond, fs.max_disp            # over every exact call

    The displacement is the sample coordinate less the output pixel
    (ix − x, iy − y), computed from the grid as :func:`grid_sample` reads
    it, so each model's grid convention is folded in; y is the output's
    global row (``row0`` + its row on a band). Every call of
    :func:`grid_sample` inside the context records (one host read each)."""

    _active: Optional["FlowStats"] = None

    def __init__(self, r: int = 8):
        self.r = r
        self.n_beyond = 0
        self.n_total = 0
        self.max_disp = 0.0
        self.calls = 0

    def __enter__(self):
        FlowStats._active = self
        return self

    def __exit__(self, *exc):
        FlowStats._active = None
        return False

    @property
    def frac_beyond(self) -> float:
        return self.n_beyond / max(self.n_total, 1)

    def _record(self, ix: torch.Tensor, iy: torch.Tensor, row0: int = 0):
        h, w = ix.shape[-2], ix.shape[-1]
        dx = ix - torch.arange(w, dtype=ix.dtype, device=ix.device)
        dy = iy - torch.arange(row0, row0 + h, dtype=iy.dtype,
                               device=iy.device)[:, None]
        r = self.r
        beyond = (dx < -r) | (dx > r - 1) | (dy < -r) | (dy > r - 1)
        self.n_beyond += int(beyond.sum())
        self.n_total += beyond.numel()
        self.max_disp = max(self.max_disp, float(dx.abs().max()),
                            float(dy.abs().max()))
        self.calls += 1


def _source_coords(grid: torch.Tensor, h: int, w: int, align_corners: bool):
    """(ix, iy), the pixel coordinates a grid samples, in the compute
    dtype: the formula of the JAX ``grid_sample``."""
    ct = _compute_dtype(grid.dtype)
    gx, gy = grid[..., 0].to(ct), grid[..., 1].to(ct)
    if align_corners:
        return (gx + 1.0) * 0.5 * (w - 1), (gy + 1.0) * 0.5 * (h - 1)
    return ((gx + 1.0) * w - 1.0) * 0.5, ((gy + 1.0) * h - 1.0) * 0.5


def grid_sample(img: torch.Tensor, grid: torch.Tensor,
                align_corners: bool = False,
                padding_mode: str = "zeros", row0: int = 0) -> torch.Tensor:
    """Exact bilinear sampling. img (N, C, H, W); grid (N, Ho, Wo, 2).
    Twice differentiable (:class:`GridSampleFunction`). Inside a
    :class:`FlowStats` context the call records its displacements, from
    global rows ``row0`` + its output rows (a band's; the sampling itself
    needs no offset)."""
    if FlowStats._active is not None:
        FlowStats._active._record(*_source_coords(
            grid.detach(), img.shape[2], img.shape[3], align_corners), row0)
    if img.dtype == torch.bfloat16:
        # the coordinates stay float32 (JAX ops/warp.py:169-171): a bf16
        # image is sampled widened and the result rounded once
        return GridSampleFunction.apply(img.float(), grid.float(),
                                        align_corners, padding_mode
                                        ).to(img.dtype)
    return GridSampleFunction.apply(img, grid.to(img.dtype), align_corners,
                                    padding_mode)


# aten's padding enum (GridSamplerPadding)
_ATEN_PADDING = {"zeros": 0, "border": 1}


def grid_sample_grads_ref(g: torch.Tensor, img: torch.Tensor,
                          grid: torch.Tensor, align_corners: bool,
                          padding_mode: str):
    """The gradients of ``F.grid_sample``'s bilinear sampler, given the
    output's cotangent ``g`` (N, C, Ho, Wo), in closed form on plain ops:
    (g_img (N, C, H, W), g_grid (N, Ho, Wo, 2)). Each tap outside the image
    counts zero; under border padding the coordinate is clipped first and
    its gradient is zero on and past the edges, as aten's backward has it.
    Autograd through this is the sampler's second derivative."""
    n, c, h, w = img.shape
    ix, iy = _source_coords(grid, h, w, align_corners)
    sx, sy = (0.5 * (w - 1), 0.5 * (h - 1)) if align_corners else (
        0.5 * w, 0.5 * h)
    if padding_mode == "border":
        inside_x = (ix > 0) & (ix < w - 1)
        inside_y = (iy > 0) & (iy < h - 1)
        ix = torch.where(inside_x, ix, ix.detach().clamp(0, w - 1))
        iy = torch.where(inside_y, iy, iy.detach().clamp(0, h - 1))
        sx, sy = sx * inside_x, sy * inside_y
    x0, y0 = ix.detach().floor(), iy.detach().floor()
    wx, wy = ix - x0, iy - y0
    ct = ix.dtype
    flat_img = img.to(ct).reshape(n, c, h * w)
    taps = []
    for dy, dx, weight in ((0, 0, (1 - wx) * (1 - wy)), (0, 1, wx * (1 - wy)),
                           (1, 0, (1 - wx) * wy), (1, 1, wx * wy)):
        xs, ys = (x0 + dx).long(), (y0 + dy).long()
        valid = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
        idx = (ys.clamp(0, h - 1) * w + xs.clamp(0, w - 1)).reshape(n, 1, -1)
        idx = idx.expand(n, c, idx.shape[-1])
        vals = flat_img.gather(2, idx).reshape(g.shape) * valid[:, None]
        taps.append((idx, valid, weight, vals))
    g = g.to(ct)
    (_, _, _, v00), (_, _, _, v01), (_, _, _, v10), (_, _, _, v11) = taps
    gx = (g * ((1 - wy)[:, None] * (v01 - v00)
               + wy[:, None] * (v11 - v10))).sum(1) * sx
    gy = (g * ((1 - wx)[:, None] * (v10 - v00)
               + wx[:, None] * (v11 - v01))).sum(1) * sy
    g_img = torch.zeros_like(flat_img)
    for idx, valid, weight, _ in taps:
        g_img = g_img.scatter_add(
            2, idx, (g * (weight * valid)[:, None]).reshape(n, c, -1))
    return (g_img.reshape(n, c, h, w).to(img.dtype),
            torch.stack([gx, gy], dim=-1).to(grid.dtype))


class GridSampleFunction(torch.autograd.Function):
    """``F.grid_sample`` (bilinear), its backward aten's
    ``grid_sampler_2d_backward`` as autograd's own, through
    :class:`GridSampleBackwardFunction` so that the backward is itself
    differentiable."""

    @staticmethod
    def forward(ctx, img, grid, align_corners, padding_mode):
        ctx.save_for_backward(img, grid)
        ctx.opts = (align_corners, padding_mode)
        return F.grid_sample(img, grid, mode="bilinear",
                             padding_mode=padding_mode,
                             align_corners=align_corners)

    @staticmethod
    def backward(ctx, g):
        img, grid = ctx.saved_tensors
        g_img, g_grid = GridSampleBackwardFunction.apply(
            g, img, grid, *ctx.opts, *ctx.needs_input_grad[:2])
        return g_img, g_grid, None, None


class GridSampleBackwardFunction(torch.autograd.Function):
    """(g, img, grid) → (g_img, g_grid) by aten's
    ``grid_sampler_2d_backward`` (None where not wanted); its derivative is
    autograd through :func:`grid_sample_grads_ref`, once: the exact sampler
    is twice differentiable."""

    @staticmethod
    def forward(ctx, g, img, grid, align_corners, padding_mode, want_img,
                want_grid):
        g_img, g_grid = torch.ops.aten.grid_sampler_2d_backward(
            g, img, grid, 0, _ATEN_PADDING[padding_mode], align_corners,
            [want_img, want_grid])
        ctx.save_for_backward(g, img, grid)
        ctx.opts = (align_corners, padding_mode)
        return (g_img if want_img else None,
                g_grid if want_grid else None)

    @staticmethod
    def backward(ctx, v_img, v_grid):
        if torch.is_grad_enabled():
            raise NotImplementedError(
                "the exact sampler is twice differentiable, not three times")
        saved = [t.detach().requires_grad_(need) for t, need in
                 zip(ctx.saved_tensors, ctx.needs_input_grad[:3])]
        with torch.enable_grad():
            g_img, g_grid = grid_sample_grads_ref(*saved, *ctx.opts)
            pairs = [(out, v) for out, v in ((g_img, v_img), (g_grid, v_grid))
                     if v is not None]
            wanted = [t for t in saved if t.requires_grad]
            grads = iter(torch.autograd.grad(
                [o for o, _ in pairs], wanted, [v for _, v in pairs],
                allow_unused=True) if pairs and wanted else ())
        return tuple(next(grads) if t.requires_grad else None
                     for t in saved) + (None,) * 4


def grid_sample_bounded(img: torch.Tensor, grid: torch.Tensor,
                        max_displacement: int, align_corners: bool = False,
                        padding_mode: str = "zeros", row0: int = 0
                        ) -> torch.Tensor:
    """Bilinear sampling exact for displacements (per axis) in [−R, R−1]
    from the output pixel and clamped to that window beyond. The grid has
    the image's H×W, or H_out rows of a band whose output row y is image
    row ``row0`` + y. Out-of-image samples follow ``padding_mode`` ('zeros'
    or 'border'). One kernel launch each way on the card
    (``ops/warp_bounded.py``); the plain composition on the CPU."""
    if padding_mode not in warp_bounded.PADDING_MODES:
        raise ValueError(f"the bounded sampler takes padding "
                         f"{warp_bounded.PADDING_MODES}, got {padding_mode!r}")
    return warp_bounded.GridSampleBoundedFunction.apply(
        img, grid, int(max_displacement), align_corners, padding_mode,
        int(row0))


def sample(img: torch.Tensor, grid: torch.Tensor, align_corners: bool,
           padding_mode: str, warp_range: Optional[int] = None,
           row0: int = 0) -> torch.Tensor:
    """Exact sampler (``warp_range`` None or 0) or the bounded fast path;
    ``row0``: the first global row of a band's grid."""
    if warp_range:
        return grid_sample_bounded(img, grid, int(warp_range),
                                   align_corners=align_corners,
                                   padding_mode=padding_mode, row0=row0)
    return grid_sample(img, grid, align_corners=align_corners,
                       padding_mode=padding_mode, row0=row0)


def _pixel_grid(img: torch.Tensor, flow: torch.Tensor, row0: int = 0):
    """(x + u, y + v), each (N, rows, W) for a flow of ``rows`` rows, the
    global rows ``row0`` + 0 .., in the compute dtype."""
    w = img.shape[3]
    ct = _compute_dtype(flow.dtype)
    xs = torch.arange(w, dtype=ct, device=flow.device)[None, None, :]
    ys = torch.arange(row0, row0 + flow.shape[1], dtype=ct,
                      device=flow.device)[None, :, None]
    return xs + flow[..., 0].to(ct), ys + flow[..., 1].to(ct)


def backward_warp(img: torch.Tensor, flow: torch.Tensor,
                  align_corners: bool = False, padding_mode: str = "zeros",
                  warp_range: Optional[int] = None, row0: int = 0
                  ) -> torch.Tensor:
    """out(y, x) = img(y + v, x + u); flow (N, H, W, 2) in pixels, or the
    rows of a band from global row ``row0``."""
    h, w = img.shape[2], img.shape[3]
    ix, iy = _pixel_grid(img, flow, row0)
    if align_corners:
        gx, gy = 2.0 * ix / (w - 1) - 1.0, 2.0 * iy / (h - 1) - 1.0
    else:
        gx, gy = (2.0 * ix + 1.0) / w - 1.0, (2.0 * iy + 1.0) / h - 1.0
    return sample(img, torch.stack([gx, gy], dim=-1),
                  align_corners=align_corners, padding_mode=padding_mode,
                  warp_range=warp_range, row0=row0)


def backward_warp_rrin(img: torch.Tensor, flow: torch.Tensor,
                       warp_range: Optional[int] = None, row0: int = 0
                       ) -> torch.Tensor:
    """RRIN's warp (reference rrin/model.py:8-21): the grid is normalised
    as ``2·(pos/size − 0.5)`` with align_corners=False, so the sample lands
    at ``pos − 0.5``; the quirk is kept for weight parity. A flow of a
    band's rows from global row ``row0`` samples the whole ``img``."""
    h, w = img.shape[2], img.shape[3]
    x, y = _pixel_grid(img, flow, row0)
    gx, gy = 2.0 * (x / w - 0.5), 2.0 * (y / h - 0.5)
    return sample(img, torch.stack([gx, gy], dim=-1), align_corners=False,
                  padding_mode="zeros", warp_range=warp_range, row0=row0)


@functools.lru_cache(maxsize=16)
def linspace(n: int, device: torch.device) -> torch.Tensor:
    """linspace(−1, 1, n) in float32 on ``device``, bit for bit as the JAX
    model's compiled ``jnp.linspace`` gives it: step = i·(1/(n−1)), value
    −(1 − step) + step, and the end point 1 exactly. ``torch.linspace``
    differs in the last bit at many points, and at small flow the floor of
    a coordinate, and so K3-grad's derivative, can turn on that bit. Made
    once a size and device, in numpy; callers must not write to it."""
    one = np.float32(1.0)
    if n == 1:
        values = np.full(1, -1.0, np.float32)
    else:
        step = np.arange(n - 1, dtype=np.float32) * (one / np.float32(n - 1))
        values = np.append(np.float32(-1.0) * (one - step) + step, one)
    return torch.from_numpy(values.astype(np.float32)).to(device)


def voxelflow_sample(frame0: torch.Tensor, frame1: torch.Tensor,
                     flow: torch.Tensor, mask: torch.Tensor,
                     warp_range: Optional[int] = None,
                     offsets: Tuple[float, float] = (-1.0, 1.0),
                     row0: int = 0) -> torch.Tensor:
    """DVF's trilinear sampling (JAX ``ops/warp.py:381-403``, reference
    voxel_flow.py:471-507). frames (N, C, H, W); ``flow`` (N, H, W, 2) in
    normalised grid units (the tanh head already halved); ``mask`` (N, 1,
    H, W) in [−1, 1]. frame0 is sampled at linspace + offsets[0]·flow,
    frame1 at linspace + offsets[1]·flow, border padding,
    align_corners=True, through :func:`sample`; the two are blended with
    (1 + mask)/2. The default (−1, 1) interpolates (JAX's function);
    VoxelFlow's extrapolation passes (−2, −1) (JAX ``models/voxelflow.py``
    :195-207). A flow and mask of a band's rows from global row ``row0``
    sample the whole frames at those rows: the whole frame's linspace,
    sliced (a band's own linspace would differ in the last bit)."""
    h, w = frame0.shape[2], frame0.shape[3]
    rows = flow.shape[1]
    gx = linspace(w, flow.device)[None, None, :]
    gy = linspace(h, flow.device)[None, row0:row0 + rows, None]
    u, v = flow[..., 0], flow[..., 1]
    a, b = offsets
    grid1 = torch.stack([gx + a * u, gy + a * v], dim=-1)
    grid2 = torch.stack([gx + b * u, gy + b * v], dim=-1)
    out1 = sample(frame0, grid1, align_corners=True, padding_mode="border",
                  warp_range=warp_range, row0=row0)
    out2 = sample(frame1, grid2, align_corners=True, padding_mode="border",
                  warp_range=warp_range, row0=row0)
    m = 0.5 * (1.0 + mask)
    return m * out1 + (1.0 - m) * out2
