"""Bounded bilinear warp — the accumulation at the heart of the fast warp.

    out(n, c, y, x) = Σ_{d,e ∈ [−R, R+1]} wy_d · wx_e · img_edge(n, c, y+d, x+e)
    wy_d = [dy0 = d](1 − fy) + [dy0 = d − 1]·fy      (wx_e likewise)

with ``img_edge`` the edge-clamped image. For floor displacements
dy0, dx0 ∈ [−R, R−1] (the caller clips them, ``ops/warp.py``) this is an
edge-clamped bilinear 2×2 tap at (y+dy0+fy, x+dx0+fx). Layout: img and
out (N, C, H, W) float32; dy0/dx0 int32 and fy/fx float32, (N, H, W).

Two hand-written CUDA kernels (``csrc/warp.cu``) carry it on the card;
each has a plain PyTorch version here that runs for CPU tensors and that
the kernels are held against:

  * :func:`warp_bounded_forward` — K3, replaces the TPU kernel
    ``meta_interpolation_tpu/ops/warp_pallas.py:86``
    (``warp_bounded_pallas``); plain version :func:`warp_bounded_ref`.
  * :func:`warp_bounded_grad_frac` — the gradient with respect to fy and
    fx, through which the flow's gradient runs; plain version
    :func:`warp_bounded_grad_frac_ref`. The JAX package has no TPU kernel
    for it (its custom VJP autodiffs the XLA sweep); on the card the
    support backward needs one so that no plain version runs there.

The gradient of the image stays plain PyTorch
(:func:`warp_bounded_grad_img_ref`). A wrapper given a CUDA tensor
launches its kernel or raises; it never falls back to the plain version.
Each wrapper counts its launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from . import _build


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def warp_bounded_ref(img: torch.Tensor, dy0: torch.Tensor, dx0: torch.Tensor,
                     fy: torch.Tensor, fx: torch.Tensor, r: int
                     ) -> torch.Tensor:
    """The (2R+2)² weighted sweep over an edge-padded copy, as the JAX
    package's ``ops/warp.py`` ``_warp_bounded_xla`` computes it.
    Differentiable by autograd."""
    h, w = img.shape[2], img.shape[3]
    imgp = F.pad(img, (r, r + 1, r, r + 1), mode="replicate")
    shifts = range(-r, r + 2)
    wys = [torch.where(dy0 == d, 1.0 - fy, 0.0)
           + torch.where(dy0 == d - 1, fy, 0.0) for d in shifts]
    wxs = [torch.where(dx0 == e, 1.0 - fx, 0.0)
           + torch.where(dx0 == e - 1, fx, 0.0) for e in shifts]
    out = torch.zeros_like(img)
    for di, d in enumerate(shifts):
        for ei, e in enumerate(shifts):
            wgt = (wys[di] * wxs[ei])[:, None]
            out = out + wgt * imgp[:, :, d + r:d + r + h, e + r:e + r + w]
    return out


def _taps(img: torch.Tensor, dy0: torch.Tensor, dx0: torch.Tensor, r: int):
    """The four edge-clamped taps (v00, v01, v10, v11), each (N, C, H, W),
    their flat indices into an (H·W) plane, and the 0/1 masks of the rows
    (my0, my1) and columns (mx0, mx1) that lie in the sweep's window
    [−R, R+1]; all masks are 1 when dy0, dx0 ∈ [−R, R−1]."""
    n, c, h, w = img.shape
    ys = torch.arange(h, device=img.device)[None, :, None]
    xs = torch.arange(w, device=img.device)[None, None, :]
    in_win = lambda d: ((d >= -r) & (d <= r + 1)).to(img.dtype)
    rows = [(ys + dy0 + k).clamp(0, h - 1) for k in (0, 1)]
    cols = [(xs + dx0 + k).clamp(0, w - 1) for k in (0, 1)]
    flat = img.reshape(n, c, h * w)
    taps, index = [], []
    for row in rows:
        for col in cols:
            idx = (row * w + col).reshape(n, 1, h * w)
            index.append(idx)
            taps.append(flat.gather(2, idx.expand(n, c, h * w))
                        .reshape(n, c, h, w))
    masks = [in_win(dy0), in_win(dy0 + 1), in_win(dx0), in_win(dx0 + 1)]
    return taps, index, masks


def warp_bounded_grad_frac_ref(img: torch.Tensor, dy0: torch.Tensor,
                               dx0: torch.Tensor, fy: torch.Tensor,
                               fx: torch.Tensor, g: torch.Tensor, r: int):
    """(gfy, gfx), each (N, H, W), for the output gradient g (N, C, H, W):

        gfy = Σ_c g_c·[my1(wx0·v10 + wx1·v11) − my0(wx0·v00 + wx1·v01)]
        gfx = Σ_c g_c·[mx1(wy0·v01 + wy1·v11) − mx0(wy0·v00 + wy1·v10)]

    over the four clamped taps, with wy0 = my0(1−fy), wy1 = my1·fy and wx
    likewise."""
    (v00, v01, v10, v11), _, (my0, my1, mx0, mx1) = _taps(img, dy0, dx0, r)
    wy0, wy1 = (my0 * (1.0 - fy))[:, None], (my1 * fy)[:, None]
    wx0, wx1 = (mx0 * (1.0 - fx))[:, None], (mx1 * fx)[:, None]
    gfy = (g * (my1[:, None] * (wx0 * v10 + wx1 * v11)
                - my0[:, None] * (wx0 * v00 + wx1 * v01))).sum(1)
    gfx = (g * (mx1[:, None] * (wy0 * v01 + wy1 * v11)
                - mx0[:, None] * (wy0 * v00 + wy1 * v10))).sum(1)
    return gfy, gfx


def warp_bounded_grad_img_ref(img: torch.Tensor, dy0: torch.Tensor,
                              dx0: torch.Tensor, fy: torch.Tensor,
                              fx: torch.Tensor, g: torch.Tensor, r: int
                              ) -> torch.Tensor:
    """The image gradient: each output pixel adds its four tap weights
    times g to the clamped taps it read (``scatter_add``)."""
    n, c, h, w = img.shape
    _, index, (my0, my1, mx0, mx1) = _taps(img, dy0, dx0, r)
    wy = [my0 * (1.0 - fy), my1 * fy]
    wx = [mx0 * (1.0 - fx), mx1 * fx]
    gimg = torch.zeros((n, c, h * w), dtype=g.dtype, device=g.device)
    for k, idx in enumerate(index):
        wgt = (wy[k // 2] * wx[k % 2])[:, None]
        gimg.scatter_add_(2, idx.expand(n, c, h * w),
                          (g * wgt).reshape(n, c, h * w))
    return gimg.reshape(n, c, h, w)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

@functools.cache
def _library() -> ctypes.CDLL:
    """csrc/warp.cu, built on first use, with its C signatures."""
    lib = _build.load("warp")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.warp_bounded_forward.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
    lib.warp_bounded_forward.restype = i32
    lib.warp_bounded_grad_frac.argtypes = [ptr] * 8 + [i32] * 5 + [ptr]
    lib.warp_bounded_grad_frac.restype = i32
    return lib


def _check_cuda(img: torch.Tensor, dy0: torch.Tensor, dx0: torch.Tensor,
                fy: torch.Tensor, fx: torch.Tensor, r: int, g=None):
    """Validate what the kernels take; returns (n, c, h, w)."""
    if img.device.type != "cuda":
        raise ValueError(f"warp kernels take CPU or CUDA tensors, got "
                         f"{img.device}")
    if img.dim() != 4:
        raise ValueError(f"image must be (N, C, H, W), got {tuple(img.shape)}")
    n, c, h, w = img.shape
    for t, dtype in [(img, torch.float32), (dy0, torch.int32),
                     (dx0, torch.int32), (fy, torch.float32),
                     (fx, torch.float32)] + (
                         [] if g is None else [(g, torch.float32)]):
        if t.device != img.device or t.dtype != dtype:
            raise ValueError(f"warp kernels take {dtype} here, got {t.dtype} "
                             f"on {t.device}")
    for t in (dy0, dx0, fy, fx):
        if tuple(t.shape) != (n, h, w):
            raise ValueError(f"coordinate plane of shape {tuple(t.shape)} "
                             f"does not match image {tuple(img.shape)}")
    if g is not None and g.shape != img.shape:
        raise ValueError(f"output gradient of shape {tuple(g.shape)} does "
                         f"not match image {tuple(img.shape)}")
    if r < 1:
        raise ValueError(f"warp range must be >= 1, got {r}")
    return n, c, h, w


def _raise_on_error(code: int, name: str):
    if code != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {code}")


def warp_bounded_forward(img: torch.Tensor, dy0: torch.Tensor,
                         dx0: torch.Tensor, fy: torch.Tensor,
                         fx: torch.Tensor, r: int) -> torch.Tensor:
    """K3: the forward. Plain version on CPU tensors, kernel on CUDA."""
    if img.device.type == "cpu":
        return warp_bounded_ref(img, dy0, dx0, fy, fx, r)
    n, c, h, w = _check_cuda(img, dy0, dx0, fy, fx, r)
    ins = [t.contiguous() for t in (img, dy0, dx0, fy, fx)]
    out = torch.empty((n, c, h, w), device=img.device, dtype=torch.float32)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = _library().warp_bounded_forward(
            *(t.data_ptr() for t in ins), out.data_ptr(), n, c, h, w, r,
            stream)
    _raise_on_error(code, "warp_bounded_forward")
    warp_bounded_forward.launches += 1
    return out


warp_bounded_forward.launches = 0


def warp_bounded_grad_frac(img: torch.Tensor, dy0: torch.Tensor,
                           dx0: torch.Tensor, fy: torch.Tensor,
                           fx: torch.Tensor, g: torch.Tensor, r: int):
    """(gfy, gfx): plain version on CPU tensors, kernel on CUDA."""
    if img.device.type == "cpu":
        return warp_bounded_grad_frac_ref(img, dy0, dx0, fy, fx, g, r)
    n, c, h, w = _check_cuda(img, dy0, dx0, fy, fx, r, g)
    ins = [t.contiguous() for t in (img, dy0, dx0, fy, fx, g)]
    gfy = torch.empty((n, h, w), device=img.device, dtype=torch.float32)
    gfx = torch.empty_like(gfy)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = _library().warp_bounded_grad_frac(
            *(t.data_ptr() for t in ins), gfy.data_ptr(), gfx.data_ptr(),
            n, c, h, w, r, stream)
    _raise_on_error(code, "warp_bounded_grad_frac")
    warp_bounded_grad_frac.launches += 1
    return gfy, gfx


warp_bounded_grad_frac.launches = 0


def reset_launches():
    warp_bounded_forward.launches = 0
    warp_bounded_grad_frac.launches = 0


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

class WarpBoundedFunction(torch.autograd.Function):
    """Forward is K3; backward is the fy/fx gradient kernel plus the plain
    image gradient when the image needs one. dy0/dx0 are integers and get
    none. The backward is not itself differentiable
    (``once_differentiable``), like the JAX custom VJP."""

    @staticmethod
    def forward(ctx, img, dy0, dx0, fy, fx, r):
        ctx.save_for_backward(img, dy0, dx0, fy, fx)
        ctx.r = r
        return warp_bounded_forward(img, dy0, dx0, fy, fx, r)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        img, dy0, dx0, fy, fx = ctx.saved_tensors
        gfy = gfx = gimg = None
        if ctx.needs_input_grad[3] or ctx.needs_input_grad[4]:
            gfy, gfx = warp_bounded_grad_frac(img, dy0, dx0, fy, fx, g, ctx.r)
        if ctx.needs_input_grad[0]:
            gimg = warp_bounded_grad_img_ref(img, dy0, dx0, fy, fx, g, ctx.r)
        return gimg, None, None, gfy, gfx, None


def warp_bounded(img: torch.Tensor, dy0: torch.Tensor, dx0: torch.Tensor,
                 fy: torch.Tensor, fx: torch.Tensor, r: int) -> torch.Tensor:
    """img (N, C, H, W); dy0/dx0 int32, fy/fx (N, H, W) → (N, C, H, W)."""
    return WarpBoundedFunction.apply(img, dy0, dx0, fy, fx, r)
