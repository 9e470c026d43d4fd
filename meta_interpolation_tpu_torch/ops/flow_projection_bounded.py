"""Bounded flow projection — kernel K4, DAIN's depth-weighted scatter-average.

Each source pixel (y, x) with flow (fx, fy) lands at (x + fx, y + fy); it
is valid only if it lands inside [0, W−1] × [0, H−1]. Its weight wv is the
inverse depth (or 1) and 0 where invalid. It adds (−fx·wv, −fy·wv) and wv
to its four clamped integer neighbours, counted with multiplicity (at the
bottom or right edge both rows are H−1 and the cell receives twice). Then

    proj = acc / max(cnt, 1e-12) where cnt > 0, else acc.

With a bound R, a neighbour whose offset from its source, target − source,
lies outside [−R, R+1] on either axis receives nothing: far sources are
dropped there, as the TPU kernel's (2R+2)² window drops them. Layout, as
the JAX package's: flow (N, H, W, 2) in (fx, fy) order, depth (N, H, W, 1)
or None; proj (N, H, W, 2), cnt (N, H, W).

  * :func:`flow_projection_bounded` — K4, replaces the TPU kernel
    ``meta_interpolation_tpu/ops/flow_projection_pallas.py:96``. On a CUDA
    tensor it launches the hand-written kernel of
    ``csrc/flow_projection.cu`` (a deterministic target-side gather) or
    raises; on a CPU tensor it runs the plain version. It counts its
    launches in ``flow_projection_bounded.launches``.
  * :func:`project_ref` — the plain version: the exact scatter (plain
    ``index_add``), with the window mask when R is given. With R None it is
    the exact projection of ``ops/flow_projection.py``, and autograd
    through it is the exact scatter's VJP.

The landing test and ``x + fx`` run in float32 (or wider for float64
flows), as in the JAX package, so that both sides take the same floors.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build


def project_ref(flow: torch.Tensor, depth_inv: Optional[torch.Tensor] = None,
                r: Optional[int] = None):
    """The scatter-average → (proj, cnt). R None: exact; else neighbours
    outside the [−R, R+1] window of their source receive nothing.
    Differentiable by autograd (the exact scatter's VJP)."""
    n, h, w, _ = flow.shape
    fx, fy = flow[..., 0], flow[..., 1]
    xs = torch.arange(w, device=flow.device)[None, None, :]
    ys = torch.arange(h, device=flow.device)[None, :, None]
    x2 = xs.to(torch.float32) + fx
    y2 = ys.to(torch.float32) + fy
    valid = (x2 >= 0) & (y2 >= 0) & (x2 <= w - 1) & (y2 <= h - 1)
    weight = depth_inv[..., 0] if depth_inv is not None else torch.ones_like(
        fx)
    wv = torch.where(valid, weight, 0.0)
    ix_l = torch.floor(x2).clamp(0, w - 1).long()
    iy_t = torch.floor(y2).clamp(0, h - 1).long()
    ix_r = (ix_l + 1).clamp(max=w - 1)
    iy_b = (iy_t + 1).clamp(max=h - 1)
    contrib = torch.stack([-fx * wv, -fy * wv, wv], dim=-1)   # (n, h, w, 3)
    base = torch.arange(n, device=flow.device)[:, None, None] * (h * w)
    index, src = [], []
    for iy, ix in ((iy_t, ix_l), (iy_t, ix_r), (iy_b, ix_l), (iy_b, ix_r)):
        index.append((base + iy * w + ix).reshape(-1))
        part = contrib
        if r is not None:
            dy, dx = iy - ys, ix - xs
            keep = (dy >= -r) & (dy <= r + 1) & (dx >= -r) & (dx <= r + 1)
            part = torch.where(keep[..., None], contrib, 0.0)
        src.append(part.reshape(-1, 3))
    acc = torch.zeros((n * h * w, 3), dtype=contrib.dtype,
                      device=flow.device).index_add(
        0, torch.cat(index), torch.cat(src)).reshape(n, h, w, 3)
    cnt = acc[..., 2]
    proj = torch.where(cnt[..., None] > 0,
                       acc[..., :2] / cnt[..., None].clamp_min(1e-12),
                       acc[..., :2])
    return proj, cnt


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C signature of csrc/flow_projection.cu on a loaded build."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flow_projection_bounded.argtypes = [ptr] * 4 + [i32] * 4 + [ptr]
    lib.flow_projection_bounded.restype = i32
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    """csrc/flow_projection.cu, built on first use, with its C signature."""
    return _bind(_build.load("flow_projection"))


def _check_cuda(flow: torch.Tensor, depth_inv: Optional[torch.Tensor],
                r: int):
    """Validate what the kernel takes; returns (n, h, w)."""
    if flow.device.type != "cuda":
        raise ValueError(f"flow projection takes CPU or CUDA tensors, got "
                         f"{flow.device}")
    if flow.dim() != 4 or flow.shape[-1] != 2:
        raise ValueError(f"flow must be (N, H, W, 2), got "
                         f"{tuple(flow.shape)}")
    n, h, w, _ = flow.shape
    for t in [flow] + ([] if depth_inv is None else [depth_inv]):
        if t.device != flow.device or t.dtype != torch.float32:
            raise ValueError(f"the flow projection kernel takes float32 on "
                             f"{flow.device}, got {t.dtype} on {t.device}")
    if depth_inv is not None and tuple(depth_inv.shape) != (n, h, w, 1):
        raise ValueError(f"depth of shape {tuple(depth_inv.shape)} does not "
                         f"match flow {tuple(flow.shape)}")
    if r < 0:
        raise ValueError(f"projection range must be >= 0, got {r}")
    return n, h, w


def flow_projection_bounded(flow: torch.Tensor,
                            depth_inv: Optional[torch.Tensor] = None,
                            max_displacement: int = 8):
    """K4 → (proj (N, H, W, 2), cnt (N, H, W)). Plain version on CPU
    tensors, the kernel on CUDA ones. Not differentiable by itself: the
    autograd Function of ``ops/flow_projection.py`` wraps it. A float32
    kernel: bfloat16 operands are widened and both results rounded back,
    on either device, as the TPU kernel's wrapper does
    (``meta_interpolation_tpu/ops/flow_projection_pallas.py:108-113``)."""
    r = int(max_displacement)
    if flow.dtype == torch.bfloat16:
        proj, cnt = flow_projection_bounded(
            flow.float(), None if depth_inv is None else depth_inv.float(), r)
        return proj.to(flow.dtype), cnt.to(flow.dtype)
    if flow.device.type == "cpu":
        return project_ref(flow, depth_inv, r)
    n, h, w = _check_cuda(flow, depth_inv, r)
    flow_c = flow.contiguous()
    depth_c = None if depth_inv is None else depth_inv.contiguous()
    proj = torch.empty((n, h, w, 2), device=flow.device, dtype=torch.float32)
    cnt = torch.empty((n, h, w), device=flow.device, dtype=torch.float32)
    with torch.cuda.device(flow.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = _library().flow_projection_bounded(
            flow_c.data_ptr(), None if depth_c is None else depth_c.data_ptr(),
            proj.data_ptr(), cnt.data_ptr(), n, h, w, r, stream)
    if code != 0:
        raise RuntimeError(f"flow_projection_bounded launch failed: "
                           f"cudaError {code}")
    flow_projection_bounded.launches += 1
    return proj, cnt


flow_projection_bounded.launches = 0


def reset_launches():
    flow_projection_bounded.launches = 0
