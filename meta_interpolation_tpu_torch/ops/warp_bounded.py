"""Bounded bilinear grid sampler — the fast warp of ``--fast_warp_range``.

Exact bilinear sampling for samples whose displacement from their output
pixel lies in [−R, R−1] per axis, clamped to that window beyond. Per output
pixel the grid is unnormalised to (ix, iy) as ``F.grid_sample`` does; the
displacement dy = clamp(iy − y, −R, R−1) splits into a floor dy0 and a
fraction fy (dx likewise), and the sample is the accumulation

    out(n, c, y, x) = Σ_{d,e ∈ [−R, R+1]} wy_d · wx_e · img_edge(n, c, y+d, x+e)
    wy_d = [dy0 = d](1 − fy) + [dy0 = d − 1]·fy      (wx_e likewise)

over the edge-clamped image: with dy0, dx0 ∈ [−R, R−1] an edge-clamped
bilinear 2×2 tap at (y+dy0+fy, x+dx0+fx). Padding 'border' clamps the
coordinate to the image first; 'zeros' rescales by the in-bounds bilinear
mass and zeroes samples whose 2×2 support lies wholly outside. Layout: img
(N, C, H, W); grid (N, H, W, 2) with (gx, gy) last and out (N, C, H, W),
the image's H×W, or for a band of output rows (the row-sharded evaluation
and training, ``--spatial_shards``) a grid and out of H_out rows, output
row y being image row row0 + y: K3, K3-grad, K3-grad² and their plain
versions take ``row0``, and a band's rows are those of the whole grid's
call bit for bit. The three have band entries in float32; the bf16
kernels raise on a band.

Plain PyTorch pieces (they run for CPU tensors; the kernels are held
against them on the card):

  * :func:`warp_bounded_ref` — the (2R+2)² sweep, as the JAX package's
    ``ops/warp.py`` ``_warp_bounded_xla``, with its fy/fx gradient
    :func:`warp_bounded_grad_frac_ref` and image gradient
    :func:`warp_bounded_grad_img_ref`, joined by :class:`WarpBoundedRef`.
  * :func:`grid_sample_bounded_ref` — the whole sampler: the coordinate
    math, the sweep and the zero-padding mass, as the JAX package's
    ``grid_sample_bounded``. Differentiable by autograd.
  * :func:`grid_sample_bounded_grad_grid_ref` — its grid gradient in closed
    form, the formula the backward kernel computes.
  * :func:`grid_sample_bounded_grad_grid_backward_ref` — that gradient's
    derivative, by autograd through the closed form.

Three hand-written CUDA kernels (``csrc/warp.cu``) carry the sampler on
the card, each one launch, grid in:

  * :func:`warp_sample_bounded_forward` — K3, replaces the TPU kernel
    ``meta_interpolation_tpu/ops/warp_pallas.py:86`` (``warp_bounded_pallas``)
    together with the coordinate math XLA fuses around it.
  * :func:`warp_sample_bounded_grad_grid` — K3-grad, the grid gradient, for
    the autodiff of the XLA sweep under the JAX package's custom VJP.
  * :func:`warp_sample_bounded_grad_grid_backward` — K3-grad², K3-grad's
    derivative in g and the grid, for second-order meta-training (the JAX
    package differentiates its XLA backward a second time).

:class:`GridSampleBoundedFunction` (K3, backward
:class:`GridSampleBoundedGradGridFunction`: K3-grad, backward K3-grad²)
joins them; the image gradient, which the models never need (they warp
input frames), stays plain (autograd through the plain composition). A
wrapper given a CUDA tensor launches its kernel or raises; it never falls
back to the plain version. Each wrapper counts its launches in
``<wrapper>.launches``.

bfloat16 (``--dtype bfloat16``): K3, K3-grad and K3-grad² take a bf16
image (and output gradient) with a grid of either type; the coordinates
are float32 (a bf16 grid is widened). K3 and K3-grad round the fractions
to bf16, sum the taps in float32 and round once, and with 'zeros' round
the mass and its product to bf16: where the JAX package's TPU path rounds
(``meta_interpolation_tpu/ops/warp.py:242-243``, ``:270``,
``warp_pallas.py:99-103``). Its CPU fallback, ``_warp_bounded_xla``,
sums the sweep in bf16 instead. K3-grad returns the grid gradient in the
grid's type. K3-grad² computes from the widened values, as the JAX
package differentiates its upcast sweep: its bf16 kernel gives the bits
of the float32 kernel on the widened operands, gg rounded once.

The bf16 kernels take one of two hand-written kernels by shape
(:func:`bf16_window`): the tile kernels, which stage each block's tap
window in shared memory as channel-interleaved texels, where C ≤ 4 and
that window fits a block's shared memory (min(16 + 2R, H) rows of
min(32 + 2R, W) texels of 8 bytes, at most 227 KB: R ≤ 72 on a large
frame, any R on a small one); else the gather kernels (the float32 design
on bf16; for K3-grad² the float32 kernel on the widened operands). Both
give the same bits. Each wrapper counts the gather route's launches also
in ``<wrapper>.gather_launches``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from . import _build

PADDING_MODES = ("zeros", "border")


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """Index and weight math runs at float32 or wider."""
    return torch.promote_types(dtype, torch.float32)


def _widen(t: torch.Tensor) -> torch.Tensor:
    """A bf16 tensor as float32 (the sums of the sampler); others as they
    are."""
    return t.float() if t.dtype == torch.bfloat16 else t


def _unnormalize(grid: torch.Tensor, h: int, w: int, align_corners: bool):
    """grid (N, Ho, Wo, 2) → pixel coordinates (ix, iy), each (N, Ho, Wo)."""
    ct = _compute_dtype(grid.dtype)
    gx, gy = grid[..., 0].to(ct), grid[..., 1].to(ct)
    if align_corners:
        return (gx + 1.0) * 0.5 * (w - 1), (gy + 1.0) * 0.5 * (h - 1)
    return ((gx + 1.0) * w - 1.0) * 0.5, ((gy + 1.0) * h - 1.0) * 0.5


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def warp_bounded_ref(img: torch.Tensor, dy0: torch.Tensor, dx0: torch.Tensor,
                     fy: torch.Tensor, fx: torch.Tensor, r: int, row0: int = 0
                     ) -> torch.Tensor:
    """The (2R+2)² weighted sweep over an edge-padded copy, as the JAX
    package's ``ops/warp.py`` ``_warp_bounded_xla`` computes it. dy0/dx0
    int32, fy/fx (N, H_out, W): the output's rows, image rows row0 ..
    row0 + H_out − 1 (the whole image by default). Differentiable by
    autograd."""
    n, c, _, w = img.shape
    rows = dy0.shape[1]
    imgp = F.pad(img, (r, r + 1, r, r + 1), mode="replicate")
    shifts = range(-r, r + 2)
    wys = [torch.where(dy0 == d, 1.0 - fy, 0.0)
           + torch.where(dy0 == d - 1, fy, 0.0) for d in shifts]
    wxs = [torch.where(dx0 == e, 1.0 - fx, 0.0)
           + torch.where(dx0 == e - 1, fx, 0.0) for e in shifts]
    out = img.new_zeros((n, c, rows, w))
    for di, d in enumerate(shifts):
        top = row0 + d + r
        for ei, e in enumerate(shifts):
            wgt = (wys[di] * wxs[ei])[:, None]
            out = out + wgt * imgp[:, :, top:top + rows, e + r:e + r + w]
    return out


def _taps(img: torch.Tensor, dy0: torch.Tensor, dx0: torch.Tensor, r: int,
          row0: int = 0):
    """The four edge-clamped taps (v00, v01, v10, v11), each (N, C, H_out,
    W) for the output rows row0 .. row0 + H_out − 1 of dy0's, their flat
    indices into the image's (H·W) plane, and the 0/1 masks of the rows
    (my0, my1) and columns (mx0, mx1) that lie in the sweep's window
    [−R, R+1]; all masks are 1 when dy0, dx0 ∈ [−R, R−1]."""
    n, c, h, w = img.shape
    ho = dy0.shape[1]
    ys = torch.arange(row0, row0 + ho, device=img.device)[None, :, None]
    xs = torch.arange(w, device=img.device)[None, None, :]
    in_win = lambda d: ((d >= -r) & (d <= r + 1)).to(img.dtype)
    rows = [(ys + dy0 + k).clamp(0, h - 1) for k in (0, 1)]
    cols = [(xs + dx0 + k).clamp(0, w - 1) for k in (0, 1)]
    flat = img.reshape(n, c, h * w)
    taps, index = [], []
    for row in rows:
        for col in cols:
            idx = (row * w + col).reshape(n, 1, ho * w)
            index.append(idx)
            taps.append(flat.gather(2, idx.expand(n, c, ho * w))
                        .reshape(n, c, ho, w))
    masks = [in_win(dy0), in_win(dy0 + 1), in_win(dx0), in_win(dx0 + 1)]
    return taps, index, masks


def warp_bounded_grad_frac_ref(img: torch.Tensor, dy0: torch.Tensor,
                               dx0: torch.Tensor, fy: torch.Tensor,
                               fx: torch.Tensor, g: torch.Tensor, r: int,
                               row0: int = 0):
    """(gfy, gfx), each (N, H_out, W), for the output gradient g (N, C,
    H_out, W) of the output rows from row0:

        gfy = Σ_c g_c·[my1(wx0·v10 + wx1·v11) − my0(wx0·v00 + wx1·v01)]
        gfx = Σ_c g_c·[mx1(wy0·v01 + wy1·v11) − mx0(wy0·v00 + wy1·v10)]

    over the four clamped taps, with wy0 = my0(1−fy), wy1 = my1·fy and wx
    likewise."""
    (v00, v01, v10, v11), _, (my0, my1, mx0, mx1) = _taps(img, dy0, dx0, r,
                                                          row0)
    wy0, wy1 = (my0 * (1.0 - fy))[:, None], (my1 * fy)[:, None]
    wx0, wx1 = (mx0 * (1.0 - fx))[:, None], (mx1 * fx)[:, None]
    gfy = (g * (my1[:, None] * (wx0 * v10 + wx1 * v11)
                - my0[:, None] * (wx0 * v00 + wx1 * v01))).sum(1)
    gfx = (g * (mx1[:, None] * (wy0 * v01 + wy1 * v11)
                - mx0[:, None] * (wy0 * v00 + wy1 * v10))).sum(1)
    return gfy, gfx


def warp_bounded_grad_img_ref(img: torch.Tensor, dy0: torch.Tensor,
                              dx0: torch.Tensor, fy: torch.Tensor,
                              fx: torch.Tensor, g: torch.Tensor, r: int,
                              row0: int = 0) -> torch.Tensor:
    """The image gradient: each output pixel adds its four tap weights
    times g to the clamped taps it read (``scatter_add``)."""
    n, c, h, w = img.shape
    ho = dy0.shape[1]
    _, index, (my0, my1, mx0, mx1) = _taps(img, dy0, dx0, r, row0)
    wy = [my0 * (1.0 - fy), my1 * fy]
    wx = [mx0 * (1.0 - fx), mx1 * fx]
    gimg = torch.zeros((n, c, h * w), dtype=g.dtype, device=g.device)
    for k, idx in enumerate(index):
        wgt = (wy[k // 2] * wx[k % 2])[:, None]
        gimg.scatter_add_(2, idx.expand(n, c, ho * w),
                          (g * wgt).reshape(n, c, ho * w))
    return gimg.reshape(n, c, h, w)


class WarpBoundedRef(torch.autograd.Function):
    """The sweep with its closed-form gradients: forward
    :func:`warp_bounded_ref`, backward :func:`warp_bounded_grad_frac_ref`
    and :func:`warp_bounded_grad_img_ref`. dy0/dx0 are integers and get
    none; ``row0`` places the output's rows in the image. The backward is
    not itself differentiable (``once_differentiable``), like the JAX
    custom VJP."""

    @staticmethod
    def forward(ctx, img, dy0, dx0, fy, fx, r, row0=0):
        ctx.save_for_backward(img, dy0, dx0, fy, fx)
        ctx.r, ctx.row0 = r, row0
        return warp_bounded_ref(img, dy0, dx0, fy, fx, r, row0)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        img, dy0, dx0, fy, fx = ctx.saved_tensors
        gfy = gfx = gimg = None
        if ctx.needs_input_grad[3] or ctx.needs_input_grad[4]:
            gfy, gfx = warp_bounded_grad_frac_ref(img, dy0, dx0, fy, fx, g,
                                                  ctx.r, ctx.row0)
        if ctx.needs_input_grad[0]:
            gimg = warp_bounded_grad_img_ref(img, dy0, dx0, fy, fx, g, ctx.r,
                                             ctx.row0)
        return gimg, None, None, gfy, gfx, None, None


def grid_sample_bounded_ref(img: torch.Tensor, grid: torch.Tensor, r: int,
                            align_corners: bool = False,
                            padding_mode: str = "zeros",
                            warp=WarpBoundedRef.apply, row0: int = 0
                            ) -> torch.Tensor:
    """The whole sampler in plain PyTorch, as the JAX package's
    ``grid_sample_bounded``; ``warp(img, dy0, dx0, fy, fx, r, row0)`` is
    the accumulation (the sweep; ``chip_smoke.py --earlier-warp`` passes an
    earlier kernel's). A grid of H_out rows samples a band: output row y
    measures its displacement from image row row0 + y (row0 + H_out ≤ H),
    and its rows are those of the whole grid's call. Differentiable by
    autograd."""
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
    ys = torch.arange(row0, row0 + grid.shape[1], dtype=ct,
                      device=img.device)[None, :, None]
    dy = (iy - ys).clamp(-r, r - 1)
    dx = (ix - xs).clamp(-r, r - 1)
    dy0f, dx0f = torch.floor(dy), torch.floor(dx)
    fy = (dy - dy0f).to(img.dtype)
    fx = (dx - dx0f).to(img.dtype)
    # a bf16 sweep runs on the widened image and fractions, rounded once
    out = warp(_widen(img), dy0f.to(torch.int32), dx0f.to(torch.int32),
               _widen(fy), _widen(fx), r, row0).to(img.dtype)

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


def _axis(i: torch.Tensor, pos: torch.Tensor, size: int, r: int,
          border: bool):
    """One axis of the sampler at the coordinates ``i`` of the outputs at
    ``pos``: (floor displacement int32, fraction, in-image mass, its
    derivative, the clamps' gradient pass-through, validity or None), with
    the operations of :func:`grid_sample_bounded_ref` in its order."""
    if border:
        passes = ((i >= 0.0) & (i <= size - 1)).to(i.dtype)
        i = i.clamp(0.0, size - 1)
        mass, dmass, valid = 1.0, 0.0, None
    else:
        passes = 1.0
        valid = (i > -1.0) & (i < size)
        i0 = torch.floor(i)
        w1 = i - i0
        m0 = ((i0 >= 0) & (i0 <= size - 1)).to(i.dtype)
        m1 = ((i0 + 1 >= 0) & (i0 + 1 <= size - 1)).to(i.dtype)
        mass, dmass = (1 - w1) * m0 + w1 * m1, m1 - m0
    d = i - pos
    passes = ((d >= -r) & (d <= r - 1)).to(i.dtype) * passes
    d = d.clamp(-r, r - 1)
    d0 = torch.floor(d)
    return d0.to(torch.int32), d - d0, mass, dmass, passes, valid


def grid_sample_bounded_grad_grid_ref(img: torch.Tensor, grid: torch.Tensor,
                                      g: torch.Tensor, r: int,
                                      align_corners: bool = False,
                                      padding_mode: str = "zeros",
                                      row0: int = 0) -> torch.Tensor:
    """The grid gradient (N, H_out, W, 2) of :func:`grid_sample_bounded_ref`
    (a band of the output rows from row0, the whole image by default) for
    the output gradient g, in closed form, per axis (x shown):

        g_ix = Σ_c g_c·[mass·cx·∂bil_c/∂fx + bil_c·Y·(mx1 − mx0)]  (zeros)
        g_ix = bx·cx·Σ_c g_c·∂bil_c/∂fx                            (border)

    with ∂bil/∂fx = wy0(v01 − v00) + wy1(v11 − v10), cx = [−R ≤ ix − x ≤
    R−1] (the clamp's gradient, inclusive), bx = [0 ≤ ix ≤ W−1], Y the
    y axis's in-image mass; 0 where a 'zeros' sample is invalid. Then g_gx
    = g_ix·W/2 ((W−1)/2 with align_corners)."""
    n, c, h, w = img.shape
    border = padding_mode == "border"
    ix, iy = _unnormalize(grid, h, w, align_corners)
    xs = torch.arange(w, dtype=ix.dtype, device=img.device)[None, None, :]
    ys = torch.arange(row0, row0 + grid.shape[1], dtype=ix.dtype,
                      device=img.device)[None, :, None]
    dx0, fx, mx, dmx, cx, vx = _axis(ix, xs, w, r, border)
    dy0, fy, my, dmy, cy, vy = _axis(iy, ys, h, r, border)
    (v00, v01, v10, v11), _, _ = _taps(_widen(img), dy0, dx0, r, row0)
    # the fractions as the forward rounds them; the sums in float32 or wider
    fx = _widen(fx.to(img.dtype))[:, None]
    fy = _widen(fy.to(img.dtype))[:, None]
    g = _widen(g)
    top = (1 - fx) * v00 + fx * v01
    bot = (1 - fx) * v10 + fx * v11
    sdx = (g * ((1 - fy) * (v01 - v00) + fy * (v11 - v10))).sum(1)
    sdy = (g * (bot - top)).sum(1)
    if border:
        gix, giy = cx * sdx, cy * sdy
    else:
        sb = (g * ((1 - fy) * top + fy * bot)).sum(1)
        mass, valid = my * mx, vx & vy
        gix = torch.where(valid, mass * cx * sdx + my * dmx * sb, 0.0)
        giy = torch.where(valid, mass * cy * sdy + mx * dmy * sb, 0.0)
    sx = 0.5 * ((w - 1) if align_corners else w)
    sy = 0.5 * ((h - 1) if align_corners else h)
    return torch.stack([gix * sx, giy * sy], -1).to(grid.dtype)


def grid_sample_bounded_grad_grid_backward_ref(img: torch.Tensor,
                                               grid: torch.Tensor,
                                               g: torch.Tensor,
                                               v: torch.Tensor, r: int,
                                               align_corners: bool = False,
                                               padding_mode: str = "zeros",
                                               row0: int = 0):
    """The derivative of :func:`grid_sample_bounded_grad_grid_ref` for the
    cotangent v (N, H_out, W, 2) of its output: (gg, ggrid), the
    cotangents of g (N, C, H_out, W) and of the grid (N, H_out, W, 2), by
    autograd through the closed form (``create_graph=True``: the result
    stays differentiable); a band of the output rows from ``row0`` as the
    closed form's. The image, on which the closed form depends linearly,
    gets none."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (g, grid)]
        out = grid_sample_bounded_grad_grid_ref(img.detach(), leaves[1],
                                                leaves[0], r, align_corners,
                                                padding_mode, row0)
        gg, ggrid = torch.autograd.grad(out, leaves, v, create_graph=True,
                                        allow_unused=True)
    return ((torch.zeros_like(g) if gg is None else gg),
            (torch.zeros_like(grid) if ggrid is None else ggrid))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C signatures of csrc/warp.cu on a loaded build."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.warp_sample_bounded_forward.argtypes = [ptr] * 3 + [i32] * 7 + [ptr]
    lib.warp_sample_bounded_forward.restype = i32
    lib.warp_sample_bounded_grad_grid.argtypes = ([ptr] * 4 + [i32] * 7
                                                  + [ptr])
    lib.warp_sample_bounded_grad_grid.restype = i32
    lib.warp_sample_bounded_grad_grid_backward.argtypes = ([ptr] * 6
                                                           + [i32] * 7
                                                           + [ptr])
    lib.warp_sample_bounded_grad_grid_backward.restype = i32
    # the float32 band entries (absent from a source from before them):
    # (…, n, c, h, w, row0, h_out, r, align_corners, border, stream)
    for name, ptrs in (("warp_sample_bounded_forward_band", 3),
                       ("warp_sample_bounded_grad_grid_band", 4),
                       ("warp_sample_bounded_grad_grid_backward_band", 6)):
        if hasattr(lib, name):
            getattr(lib, name).argtypes = [ptr] * ptrs + [i32] * 9 + [ptr]
            getattr(lib, name).restype = i32
    # the bf16 kernels, tiled and gather (absent from a source from before
    # them)
    for name in ("warp_sample_bounded_forward",
                 "warp_sample_bounded_grad_grid",
                 "warp_sample_bounded_grad_grid_backward"):
        for suffix in ("_bf16", "_bf16_gather"):
            if hasattr(lib, name + suffix):
                fn = getattr(lib, name + suffix)
                fn.argtypes = getattr(lib, name).argtypes
                fn.restype = i32
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    """csrc/warp.cu, built on first use, with its C signatures."""
    return _bind(_build.load("warp"))


KERNEL_DTYPES = (torch.float32, torch.bfloat16)

# The bf16 tile kernels of K3, K3-grad and K3-grad² (csrc/warp.cu): a
# block's output tile (kTileH, kTileW), the channels a staged texel holds
# (kTexelC) and its bytes, and the shared memory a block may take on sm_90
# (kMaxWindowBytes)
BF16_TILE = (16, 32)
TEXEL_CHANNELS, TEXEL_BYTES = 4, 8
MAX_WINDOW_BYTES = 232448


class Window(NamedTuple):
    """The bf16 kernel that takes a call, and the tap window each of its
    blocks stages: at most ``rows`` x ``cols`` texels (``cols`` the row
    pitch, whole chunks of 8), ``shared_bytes`` in all."""
    route: str   # "tile" (the tile kernels) or "gather"
    rows: int
    cols: int
    shared_bytes: int


def window_span(t: int, length: int, r: int, size: int) -> Tuple[int, int]:
    """The first and last index, along one axis of ``size``, that tile
    ``t`` of ``length`` outputs stages: every tap of an output at p lies in
    [p − R, p + R] (floors in [−R, R−1], edge-clamped), clipped to the
    image."""
    first = t * length
    return max(first - r, 0), min(first + length - 1 + r, size - 1)


def bf16_window(n: int, c: int, h: int, w: int, r: int,
                tile: Tuple[int, int] = BF16_TILE) -> Window:
    """The route and window of a bf16 K3, K3-grad or K3-grad² call on an
    (N, C, H, W) image at R: the tile kernels where a texel holds every
    channel (C ≤ 4) and the largest block window, min(TH + 2R, H) rows of
    min(TW + 2R, W) texels, fits a block's shared memory; else the gather
    kernels. The C entry points size their launch by the same rule."""
    rows = min(tile[0] + 2 * r, h)
    cols = -(-min(tile[1] + 2 * r, w) // 8) * 8
    nbytes = rows * cols * TEXEL_BYTES
    fits = c <= TEXEL_CHANNELS and nbytes <= MAX_WINDOW_BYTES
    return Window("tile" if fits else "gather", rows, cols, nbytes)


def _entry(lib, name: str, img: torch.Tensor, r: int):
    """The C entry point of K3 (``name`` warp_sample_bounded_forward),
    K3-grad or K3-grad² for ``img``, and its route: float32 its kernel
    (route None); bf16 the tile kernel or, where :func:`bf16_window` sends
    the call there, the gather one (K3-grad² has none: its wrapper widens
    such a call onto the float32 kernel). Never a plain version."""
    if img.dtype != torch.bfloat16:
        return getattr(lib, name), None
    route = bf16_window(*img.shape, r).route
    suffix = "_bf16" if route == "tile" else "_bf16_gather"
    return getattr(lib, name + suffix), route


def is_band(img: torch.Tensor, grid: torch.Tensor, row0: int) -> bool:
    """Whether a call samples a band of output rows (a grid of other rows
    than the image's, or rows from ``row0`` > 0) rather than the whole
    frame."""
    return row0 != 0 or grid.shape[1] != img.shape[2]


def _check(img: torch.Tensor, grid: torch.Tensor, r: int, padding_mode: str,
           g=None, v=None, row0: int = 0):
    """Validate what the kernels take, in one pass; returns (n, c, h, w).
    The image is float32 or bfloat16 and g of its type; the grid and v are
    float32 or bfloat16 (the wrappers widen a bf16 grid). The grid holds
    H_out rows from ``row0`` (row0 + H_out ≤ H; g holds H_out rows too)."""
    if img.device.type != "cuda":
        raise ValueError(f"warp kernels take CPU or CUDA tensors, got "
                         f"{img.device}")
    n, c, h, w = img.shape
    ho = grid.shape[1] if grid.dim() == 4 else -1

    def bad(t, like, dtypes):
        return t is not None and (tuple(t.shape) != like
                                  or t.device != img.device
                                  or t.dtype not in dtypes)
    if (tuple(grid.shape) != (n, ho, w, 2) or not 0 <= row0 <= h - ho
            or ho < 1 or grid.device != img.device
            or img.dtype not in KERNEL_DTYPES
            or grid.dtype not in KERNEL_DTYPES
            or bad(g, (n, c, ho, w), (img.dtype,))
            or bad(v, tuple(grid.shape), KERNEL_DTYPES)
            or r < 1 or padding_mode not in PADDING_MODES):
        raise ValueError(
            f"warp kernels take a float32 or bfloat16 image (N, C, H, W), a "
            f"grid (N, H_out, W, 2) of rows row0 .. row0 + H_out - 1 of the "
            f"image's, an output gradient (N, C, H_out, W) of the image's "
            f"type and a grid cotangent of the grid's shape, on one "
            f"device, R >= 1 and padding {PADDING_MODES}; got image "
            f"{tuple(img.shape)} {img.dtype}, grid {tuple(grid.shape)} "
            f"{grid.dtype} on {grid.device}, row0 {row0}"
            + ("" if g is None else f", g {tuple(g.shape)} {g.dtype}")
            + ("" if v is None else f", v {tuple(v.shape)} {v.dtype}")
            + f", R={r}, padding {padding_mode!r}")
    return n, c, h, w


def _launch(fn, device: torch.device, *args) -> int:
    """``fn(*args, stream)`` on ``device``'s current stream, switching the
    current device only when it is another."""
    if device.index == torch.cuda.current_device():
        return fn(*args, torch.cuda.current_stream().cuda_stream)
    with torch.cuda.device(device):
        return fn(*args, torch.cuda.current_stream().cuda_stream)


def _aligned(grid: torch.Tensor) -> torch.Tensor:
    """The grid, float32 and contiguous; the kernels read a pixel's (gx,
    gy) as one 8-byte load, so a grid that is not 8-byte aligned is
    copied."""
    grid = grid.float().contiguous()
    if grid.data_ptr() % 8:
        grid = grid.clone()
    return grid


def _band_launch(name: str, img: torch.Tensor, ptrs, n, c, h, w, row0, ho,
                 r, align_corners, padding_mode):
    """Launch the float32 band entry ``name`` (K3, K3-grad or K3-grad²) on
    the tensors at ``ptrs``."""
    code = _launch(getattr(_library(), name), img.device, *ptrs, n, c, h, w,
                   row0, ho, r, int(align_corners),
                   int(padding_mode == "border"))
    if code != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {code}")


def _no_band_dtype(what: str, img: torch.Tensor):
    """Refuse a bf16 band call: the bf16 kernels have no band form."""
    if img.dtype == torch.bfloat16:
        raise NotImplementedError(
            f"{what}: a band of rows is not bfloat16 (the bf16 kernels have "
            f"no band form)")


def warp_sample_bounded_forward(img: torch.Tensor, grid: torch.Tensor,
                                r: int, align_corners: bool = False,
                                padding_mode: str = "zeros",
                                row0: int = 0) -> torch.Tensor:
    """K3: the sampler's output (N, C, H_out, W), of the image's type, for
    a grid (N, H_out, W, 2): the whole frame, or a band of the output rows
    from ``row0`` (float32 only; ``warp_sample_bounded_forward_band``,
    counted in ``band_launches`` too). Plain version on CPU tensors, the
    kernel on CUDA: in bf16 the tile kernel, or the gather one past its
    limit (C > 4, or a window over 227 KB of shared memory;
    :func:`bf16_window`)."""
    band = is_band(img, grid, row0)
    if band:
        _no_band_dtype("warp_sample_bounded_forward", img)
    if img.device.type == "cpu":
        return grid_sample_bounded_ref(img, grid, r, align_corners,
                                       padding_mode, row0=row0)
    n, c, h, w = _check(img, grid, r, padding_mode, row0=row0)
    img, grid = img.contiguous(), _aligned(grid)
    out = img.new_empty((n, c, grid.shape[1], w))
    if band:
        _band_launch("warp_sample_bounded_forward_band", img,
                     (img.data_ptr(), grid.data_ptr(), out.data_ptr()), n, c,
                     h, w, row0, grid.shape[1], r, align_corners,
                     padding_mode)
        warp_sample_bounded_forward.launches += 1
        warp_sample_bounded_forward.band_launches += 1
        return out
    fn, route = _entry(_library(), "warp_sample_bounded_forward", img, r)
    code = _launch(fn, img.device,
                   img.data_ptr(), grid.data_ptr(), out.data_ptr(), n, c, h,
                   w, r, int(align_corners), int(padding_mode == "border"))
    if code != 0:
        raise RuntimeError(f"warp_sample_bounded_forward launch failed: "
                           f"cudaError {code}")
    warp_sample_bounded_forward.launches += 1
    if route == "gather":
        warp_sample_bounded_forward.gather_launches += 1
    return out


warp_sample_bounded_forward.launches = 0
warp_sample_bounded_forward.gather_launches = 0
warp_sample_bounded_forward.band_launches = 0


def warp_sample_bounded_grad_grid(img: torch.Tensor, grid: torch.Tensor,
                                  g: torch.Tensor, r: int,
                                  align_corners: bool = False,
                                  padding_mode: str = "zeros",
                                  row0: int = 0) -> torch.Tensor:
    """K3-grad: the grid gradient (N, H_out, W, 2), of the grid's type, for
    the output gradient g (N, C, H_out, W); a band from ``row0`` as K3's
    (``warp_sample_bounded_grad_grid_band``, ``band_launches``). The closed
    form on CPU tensors, the kernel on CUDA: in bf16 the tile kernel, or
    the gather one past its limit (as K3's)."""
    band = is_band(img, grid, row0)
    if band:
        _no_band_dtype("warp_sample_bounded_grad_grid", img)
    if img.device.type == "cpu":
        return grid_sample_bounded_grad_grid_ref(img, grid, g, r,
                                                 align_corners, padding_mode,
                                                 row0)
    n, c, h, w = _check(img, grid, r, padding_mode, g, row0=row0)
    dtype = grid.dtype
    img, grid, g = img.contiguous(), _aligned(grid), _build.dense(g)
    ggrid = torch.empty_like(grid)
    if band:
        _band_launch("warp_sample_bounded_grad_grid_band", img,
                     (img.data_ptr(), grid.data_ptr(), g.data_ptr(),
                      ggrid.data_ptr()), n, c, h, w, row0, grid.shape[1], r,
                     align_corners, padding_mode)
        warp_sample_bounded_grad_grid.launches += 1
        warp_sample_bounded_grad_grid.band_launches += 1
        return ggrid.to(dtype)
    fn, route = _entry(_library(), "warp_sample_bounded_grad_grid", img, r)
    code = _launch(fn, img.device,
                   img.data_ptr(), grid.data_ptr(), g.data_ptr(),
                   ggrid.data_ptr(), n, c, h, w, r, int(align_corners),
                   int(padding_mode == "border"))
    if code != 0:
        raise RuntimeError(f"warp_sample_bounded_grad_grid launch failed: "
                           f"cudaError {code}")
    warp_sample_bounded_grad_grid.launches += 1
    if route == "gather":
        warp_sample_bounded_grad_grid.gather_launches += 1
    return ggrid.to(dtype)


warp_sample_bounded_grad_grid.launches = 0
warp_sample_bounded_grad_grid.gather_launches = 0
warp_sample_bounded_grad_grid.band_launches = 0


def warp_sample_bounded_grad_grid_backward(img: torch.Tensor,
                                           grid: torch.Tensor,
                                           g: torch.Tensor, v: torch.Tensor,
                                           r: int,
                                           align_corners: bool = False,
                                           padding_mode: str = "zeros",
                                           row0: int = 0):
    """K3-grad²: (gg, ggrid), K3-grad's derivative for the cotangent v
    (N, H_out, W, 2) of its output, with respect to g and to the grid,
    each of its input's type, computed from the widened values; a band
    from ``row0`` as K3-grad's (float32 only;
    ``warp_sample_bounded_grad_grid_backward_band``, counted in
    ``band_launches`` too). The plain version on CPU tensors (bf16 ones
    widened and the results rounded back), the kernel on CUDA: float32 its
    kernel; bf16 the tile kernel or, past its limit (C > 4, or a window
    over 227 KB of shared memory; :func:`bf16_window`), the float32 kernel
    on the widened operands, gg rounded back (counted in
    ``gather_launches``)."""
    band = is_band(img, grid, row0)
    if band:
        _no_band_dtype("warp_sample_bounded_grad_grid_backward", img)
    if img.device.type == "cpu":
        gg, ggrid = grid_sample_bounded_grad_grid_backward_ref(
            _widen(img), _widen(grid), _widen(g), _widen(v), r,
            align_corners, padding_mode, row0)
        return gg.to(g.dtype), ggrid.to(grid.dtype)
    n, c, h, w = _check(img, grid, r, padding_mode, g, v, row0=row0)
    if band:
        dtype = grid.dtype
        img, grid, g, v = (img.contiguous(), _aligned(grid), _build.dense(g),
                           _aligned(_build.dense(v)))
        gg, ggrid = torch.empty_like(g), torch.empty_like(grid)
        _band_launch("warp_sample_bounded_grad_grid_backward_band", img,
                     (img.data_ptr(), grid.data_ptr(), g.data_ptr(),
                      v.data_ptr(), gg.data_ptr(), ggrid.data_ptr()), n, c,
                     h, w, row0, grid.shape[1], r, align_corners,
                     padding_mode)
        warp_sample_bounded_grad_grid_backward.launches += 1
        warp_sample_bounded_grad_grid_backward.band_launches += 1
        return gg, ggrid.to(dtype)
    if (img.dtype == torch.bfloat16
            and bf16_window(n, c, h, w, r).route == "gather"):
        gg, ggrid = warp_sample_bounded_grad_grid_backward(
            img.float(), grid, g.float(), v, r, align_corners, padding_mode)
        warp_sample_bounded_grad_grid_backward.gather_launches += 1
        return gg.to(g.dtype), ggrid
    fn, _ = _entry(_library(), "warp_sample_bounded_grad_grid_backward",
                   img, r)
    dtype = grid.dtype
    img, grid, g, v = (img.contiguous(), _aligned(grid), _build.dense(g),
                       _aligned(_build.dense(v)))
    gg, ggrid = torch.empty_like(g), torch.empty_like(grid)
    code = _launch(fn, img.device, img.data_ptr(), grid.data_ptr(),
                   g.data_ptr(), v.data_ptr(), gg.data_ptr(),
                   ggrid.data_ptr(), n, c, h, w, r, int(align_corners),
                   int(padding_mode == "border"))
    if code != 0:
        raise RuntimeError(f"warp_sample_bounded_grad_grid_backward launch "
                           f"failed: cudaError {code}")
    warp_sample_bounded_grad_grid_backward.launches += 1
    return gg, ggrid.to(dtype)


warp_sample_bounded_grad_grid_backward.launches = 0
warp_sample_bounded_grad_grid_backward.gather_launches = 0
warp_sample_bounded_grad_grid_backward.band_launches = 0


def reset_launches():
    for fn in (warp_sample_bounded_forward, warp_sample_bounded_grad_grid,
               warp_sample_bounded_grad_grid_backward):
        fn.launches = fn.gather_launches = fn.band_launches = 0


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

class GridSampleBoundedFunction(torch.autograd.Function):
    """Inputs (img, grid), with R, align_corners, padding_mode and the
    band's first row ``row0`` fixed. Forward is K3; backward is
    :class:`GridSampleBoundedGradGridFunction` (K3-grad, itself
    differentiable by K3-grad² on whole frames) for the grid and, only
    when the image needs one, the plain image gradient (autograd through
    :func:`grid_sample_bounded_ref`, once differentiable). Twice
    differentiable in the grid, as the JAX package's XLA backward is, on
    whole frames and on bands."""

    @staticmethod
    def forward(ctx, img, grid, r, align_corners, padding_mode, row0=0):
        ctx.save_for_backward(img, grid)
        ctx.opts = (r, align_corners, padding_mode, row0)
        return warp_sample_bounded_forward(img, grid, *ctx.opts)

    @staticmethod
    def backward(ctx, g):
        img, grid = ctx.saved_tensors
        gimg = ggrid = None
        if ctx.needs_input_grad[1]:
            ggrid = GridSampleBoundedGradGridFunction.apply(img, grid, g,
                                                            *ctx.opts)
        if ctx.needs_input_grad[0]:
            if torch.is_grad_enabled():
                raise NotImplementedError(
                    "the bounded sampler's image gradient is not itself "
                    "differentiable: second order needs an image that "
                    "takes no gradient (the models warp input frames)")
            with torch.enable_grad():
                leaf = img.detach().requires_grad_()
                r, align_corners, padding_mode, row0 = ctx.opts
                out = grid_sample_bounded_ref(leaf, grid.detach(), r,
                                              align_corners, padding_mode,
                                              row0=row0)
                gimg, = torch.autograd.grad(out, leaf, g)
        return gimg, ggrid, None, None, None, None


class GridSampleBoundedGradGridFunction(torch.autograd.Function):
    """The grid gradient of the sampler as a function of (img, grid, g),
    with R, align_corners, padding_mode and ``row0`` fixed: forward
    K3-grad, backward K3-grad² for g and the grid (on a band its band
    entry) and, only when the image needs one, the plain image term
    (autograd through the closed form). The backward is not itself
    differentiable (``once_differentiable``): second-order meta-training
    needs no third derivative."""

    @staticmethod
    def forward(ctx, img, grid, g, r, align_corners, padding_mode, row0=0):
        ctx.save_for_backward(img, grid, g)
        ctx.opts = (r, align_corners, padding_mode)
        ctx.row0 = row0
        return warp_sample_bounded_grad_grid(img, grid, g, *ctx.opts, row0)

    @staticmethod
    @once_differentiable
    def backward(ctx, v):
        img, grid, g = ctx.saved_tensors
        gimg = ggrid = gg = None
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            gg, ggrid = warp_sample_bounded_grad_grid_backward(
                img, grid, g, v, *ctx.opts, ctx.row0)
        if ctx.needs_input_grad[0]:
            with torch.enable_grad():
                leaf = img.detach().requires_grad_()
                out = grid_sample_bounded_grad_grid_ref(
                    leaf, grid.detach(), g.detach(), *ctx.opts, ctx.row0)
                gimg, = torch.autograd.grad(out, leaf, v)
        return (gimg, ggrid if ctx.needs_input_grad[1] else None,
                gg if ctx.needs_input_grad[2] else None, None, None, None,
                None)
