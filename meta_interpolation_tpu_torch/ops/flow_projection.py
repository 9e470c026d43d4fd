"""Flow projection — DAIN's depth-weighted scatter-average of the negated
flow onto the target grid, with directional hole filling.

Counterpart of ``meta_interpolation_tpu/ops/flow_projection.py`` (the
reference's ``depthflowprojection_cuda_kernel.cu`` and
``FlowFillhole_kernelfunc``). Flow (N, H, W, 2) in (fx, fy) order, depth
(N, H, W, 1) or None, as in the JAX package.

  * ``proj_range`` None: the exact scatter (``flow_projection_bounded.
    project_ref``, plain ``index_add``), differentiable by autograd.
  * ``proj_range`` R: kernel K4 (``ops/flow_projection_bounded.py``) on a
    CUDA tensor and its plain version on a CPU tensor, for every shape.
    Exact for flows within R pixels; farther sources are dropped. Its
    backward is the exact scatter's VJP (:class:`FlowProjectionFunction`),
    as the JAX package's custom VJP has it. Unlike the JAX package, which
    takes the kernel only on a TPU with H % 8 == 0, it never silently
    takes the exact scatter instead.
  * ``fill_hole``: cells that received nothing get the mean of the nearest
    received cell in each of the four axis directions; the gradient is
    that of the unfilled value (the reference backward ignores the fill).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from .flow_projection_bounded import flow_projection_bounded, project_ref


class FlowProjectionFunction(torch.autograd.Function):
    """Forward: K4 (or its plain version on the CPU) → (proj, cnt). Backward:
    the exact scatter's VJP, plain PyTorch; cnt carries no gradient."""

    @staticmethod
    def forward(ctx, flow, depth_inv, r):
        proj, cnt = flow_projection_bounded(flow, depth_inv, r)
        ctx.save_for_backward(flow, depth_inv)
        ctx.mark_non_differentiable(cnt)
        return proj, cnt

    @staticmethod
    @once_differentiable
    def backward(ctx, g, _g_cnt):
        flow, depth_inv = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [flow.detach().requires_grad_(ctx.needs_input_grad[0])]
            if depth_inv is not None:
                leaves.append(depth_inv.detach().requires_grad_(
                    ctx.needs_input_grad[1]))
            proj, _ = project_ref(leaves[0], leaves[1] if len(leaves) > 1
                                  else None)
            wanted = [t for t in leaves if t.requires_grad]
            grads = iter(torch.autograd.grad(proj, wanted, g))
        out = [next(grads) if t.requires_grad else None for t in leaves]
        return out[0], (out[1] if len(out) > 1 else None), None


def flow_projection(flow: torch.Tensor,
                    depth_inv: Optional[torch.Tensor] = None,
                    fill_hole: bool = False,
                    proj_range: Optional[int] = None) -> torch.Tensor:
    """Project flow t→0 onto the target grid → (N, H, W, 2)."""
    if proj_range is not None:
        out, cnt = FlowProjectionFunction.apply(flow, depth_inv,
                                                int(proj_range))
    else:
        out, cnt = project_ref(flow, depth_inv)
    if fill_hole:
        out = fill_holes_no_grad(out, cnt)
    return out


def min_depth_flow_projection(flow: torch.Tensor, depth_inv: torch.Tensor,
                              fill_hole: bool = False) -> torch.Tensor:
    """The z-buffer variant (reference ``mindepthflowprojection_cuda_
    kernel.cu:29-115``; JAX ``ops/flow_projection.min_depth_flow_projection``):
    each target cell keeps the −flow of the source with the largest
    inverse-depth weight (the nearest surface), written to its top-left
    neighbour only (the reference's other three are commented out, :93-108).
    Where the CUDA version's read-modify-write races on a tie, the tied
    winners' flows are averaged, as in JAX. Plain PyTorch (a max scatter,
    then the winners' ``index_add``); the gradient reaches the flow
    through the winners' values, none reaches the depth. flow (N, H, W, 2),
    depth_inv (N, H, W, 1) → (N, H, W, 2)."""
    n, h, w, _ = flow.shape
    fx, fy = flow[..., 0], flow[..., 1]
    xs = torch.arange(w, dtype=flow.dtype, device=flow.device)[None, None, :]
    ys = torch.arange(h, dtype=flow.dtype, device=flow.device)[None, :, None]
    x2, y2 = xs + fx, ys + fy
    valid = (x2 >= 0) & (y2 >= 0) & (x2 <= w - 1) & (y2 <= h - 1)
    ix = torch.floor(x2).long().clamp(0, w - 1)
    iy = torch.floor(y2).long().clamp(0, h - 1)
    wv = torch.where(valid, depth_inv[..., 0], depth_inv.new_zeros(()))
    idx = ((torch.arange(n, device=flow.device) * (h * w))[:, None, None]
           + iy * w + ix).reshape(-1)
    cell_max = flow.new_zeros(n * h * w).scatter_reduce(
        0, idx, wv.detach().reshape(-1), "amax")
    winner = valid & (wv >= cell_max[idx].reshape(n, h, w)) & (wv > 0)
    contrib = torch.stack([-fx, -fy], dim=-1) * winner[..., None]
    acc = flow.new_zeros((n * h * w, 2)).index_add(0, idx,
                                                   contrib.reshape(-1, 2))
    n_win = flow.new_zeros(n * h * w).index_add(
        0, idx, winner.to(flow.dtype).reshape(-1))
    acc, n_win = acc.reshape(n, h, w, 2), n_win.reshape(n, h, w)
    out = torch.where(n_win[..., None] > 0,
                      acc / n_win[..., None].clamp_min(1.0),
                      acc.new_zeros(()))
    if fill_hole:
        out = fill_holes_no_grad(out, n_win)
    return out


def fill_holes_no_grad(out: torch.Tensor, cnt: torch.Tensor
                       ) -> torch.Tensor:
    """Forward: hole-filled; backward: as if unfilled (the JAX package's
    ``_fill_holes_no_grad``, with the same arithmetic)."""
    return out + (fill_holes(out, cnt) - out).detach()


def _nearest_valid(valid: torch.Tensor, dim: int, after: bool):
    """Index of the nearest valid element at or before (``after``: at or
    after) each position along ``dim`` → (index clamped into range, found)."""
    size = valid.shape[dim]
    shape = [1] * valid.dim()
    shape[dim] = size
    idx = torch.arange(size, device=valid.device).reshape(shape)
    if not after:
        near = torch.where(valid, idx, -1).cummax(dim).values
        return near.clamp_min(0), near >= 0
    near = torch.where(valid, idx, size).flip(dim).cummin(dim).values.flip(
        dim)
    return near.clamp_max(size - 1), near < size


def fill_holes(out: torch.Tensor, cnt: torch.Tensor) -> torch.Tensor:
    """Directional nearest-valid averaging (reference
    ``FlowFillhole_kernelfunc``): cummax/cummin of masked indices and a
    gather, equal to the JAX package's ``_fill_holes_scan``. out (N, H, W,
    2), cnt (N, H, W)."""
    valid = cnt > 0
    vals, masks = [], []
    for dim, after in ((2, False), (2, True), (1, False), (1, True)):
        idx, found = _nearest_valid(valid, dim, after)
        vals.append(out.gather(dim, idx[..., None].expand_as(out)))
        masks.append(found.to(out.dtype)[..., None])
    v_l, v_r, v_u, v_d = vals
    ml, mr, mu, md = masks
    total = ml + mr + mu + md
    filled = (v_l * ml + v_r * mr + v_u * mu + v_d * md) / total.clamp_min(
        1.0)
    hole = (~valid)[..., None] & (total > 0)
    return torch.where(hole, filled, out)
