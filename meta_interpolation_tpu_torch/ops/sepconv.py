"""Adaptive separable convolution — the SepConv hot op.

    out(n, c, y, x) = Σ_k Σ_l in(n, c, y+k, x+l) · kv(n, k, y, x) · kh(n, l, y, x)

with filter size F = 51: a per-pixel rank-1 (vertical ⊗ horizontal) filter
applied to a replicate-padded input. Layout is the model's NCHW: input
(N, C, H+F−1, W+F−1), kernel maps kv/kh (N, F, H, W), output (N, C, H, W).

Two hand-written CUDA kernels (``csrc/sepconv.cu``) carry the op on the
card; each has a plain PyTorch version here that runs for CPU tensors and
that the kernels are held against:

  * :func:`sepconv_forward` — K1, replaces the TPU forward kernel
    ``meta_interpolation_tpu/ops/sepconv.py:134`` (``_pallas_forward``);
    plain version :func:`sepconv_ref`.
  * :func:`sepconv_grad_kernels` — K2, the fused gradient of both kernel
    maps, replaces ``meta_interpolation_tpu/ops/sepconv.py:233``
    (``_pallas_grad_kernels``); plain version :func:`grad_kernels_ref`.

The gradient of the input stays plain PyTorch (:func:`grad_input_ref`), as
it stays plain jnp in the JAX package. A wrapper given a CUDA tensor
launches its kernel or raises; it never falls back to the plain version.
Each wrapper counts its launches in ``<wrapper>.launches``.

Both kernels take float32 or bfloat16 (all operands of one type; a
template instantiation each). In bf16 they widen every value to float32,
sum in float32 and round each output once, as the TPU kernels do
(``meta_interpolation_tpu/ops/sepconv.py:139-143``, ``:237-241``); on CPU
tensors the wrappers do the same around the plain versions
(:func:`_widened`). The JAX package's own CPU fallback, ``sepconv_ref``,
sums its taps in bf16 instead.

:func:`sepconv` is twice differentiable from the two kernels (second-order
meta-training differentiates through its backward): the backward is K2
wrapped in :class:`SepConvGradKernelsFunction`, whose own backward is two
K1 calls and one K2 call, with the input's part plain.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build

F_TAPS = 51
KERNEL_MAX_TAPS = 51  # csrc/sepconv.cu kFMax
KERNEL_CHANNELS = 3   # csrc/sepconv.cu kC


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _shapes(inp: torch.Tensor, kv: torch.Tensor):
    n, c, hp, wp = inp.shape
    f = kv.shape[1]
    return n, c, hp - f + 1, wp - f + 1, f


def sepconv_ref(inp: torch.Tensor, kv: torch.Tensor, kh: torch.Tensor
                ) -> torch.Tensor:
    """Shift-and-accumulate over the vertical taps k, with the horizontal
    taps l gathered by ``unfold`` and summed by a broadcast product (an
    einsum here runs a batched matrix product per pixel, ~5× slower on the
    CPU). Differentiable by autograd."""
    n, c, h, w, f = _shapes(inp, kv)
    kh_l = kh.permute(0, 2, 3, 1)[:, None]  # (N, 1, H, W, F)
    out = inp.new_zeros((n, c, h, w))
    for k in range(f):
        win = inp[:, :, k:k + h, :].unfold(3, f, 1)  # (N, C, H, W, F)
        out = out + (win * kh_l).sum(-1) * kv[:, None, k]
    return out


def grad_kernels_ref(inp: torch.Tensor, g: torch.Tensor, kv: torch.Tensor,
                     kh: torch.Tensor):
    """(gkv, gkh), each (N, F, H, W): gw(k,l) = Σ_c g_c·in(y+k, x+l, c),
    gkv(k) = Σ_l kh_l·gw(k,l), gkh(l) = Σ_k kv_k·gw(k,l)."""
    n, c, h, w, f = _shapes(inp, kv)
    gkv = torch.empty_like(kv)
    gkh = torch.zeros_like(kh)
    for k in range(f):
        win = inp[:, :, k:k + h, :].unfold(3, f, 1)  # (N, C, H, W, F)
        gw = (win * g[..., None]).sum(1).permute(0, 3, 1, 2)  # (N, F, H, W)
        gkv[:, k] = (gw * kh).sum(1)
        gkh += gw * kv[:, k:k + 1]
    return gkv, gkh


def grad_input_ref(g: torch.Tensor, kv: torch.Tensor, kh: torch.Tensor,
                   hp: int, wp: int) -> torch.Tensor:
    """gin(y+k, x+l, c) += g(y, x, c)·kv_k·kh_l, one ``fold`` per k."""
    n, c, h, w = g.shape
    f = kv.shape[1]
    gin = g.new_zeros((n, c, hp, wp))
    for k in range(f):
        taps = (g * kv[:, None, k])[:, :, None] * kh[:, None]  # (N,C,F,H,W)
        gin[:, :, k:k + h] += F.fold(taps.reshape(n, c * f, h * w),
                                     output_size=(h, wp), kernel_size=(1, f))
    return gin


def _widened(fn, *args):
    """``fn`` on ``args`` widened to float32 when they are bfloat16, each
    result rounded back once: the kernels' function in bf16. Other types
    pass through unchanged."""
    dtype = args[0].dtype
    if dtype != torch.bfloat16:
        return fn(*args)
    out = fn(*(a.float() for a in args))
    if isinstance(out, tuple):
        return tuple(o.to(dtype) for o in out)
    return out.to(dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C signatures of csrc/sepconv.cu's entry points on ``lib``."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.sepconv_forward.argtypes = [ptr] * 4 + [i32] * 5 + [ptr]
    lib.sepconv_forward.restype = i32
    lib.sepconv_grad_kernels.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
    lib.sepconv_grad_kernels.restype = i32
    # the bf16 instantiations (a source from before them has none)
    if hasattr(lib, "sepconv_forward_bf16"):
        lib.sepconv_forward_bf16.argtypes = lib.sepconv_forward.argtypes
        lib.sepconv_forward_bf16.restype = i32
        lib.sepconv_grad_kernels_bf16.argtypes = (
            lib.sepconv_grad_kernels.argtypes)
        lib.sepconv_grad_kernels_bf16.restype = i32
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    """csrc/sepconv.cu, built on first use, with its C signatures."""
    return _bind(_build.load("sepconv"))


def _kernel_shapes(inp: torch.Tensor, *maps: torch.Tensor):
    """Validate the types and shapes the kernels take, on any device;
    returns (n, c, h, w, f)."""
    n, c, h, w, f = _shapes(inp, maps[0])
    for t in (inp,) + maps:
        if (t.device != inp.device or t.dtype != inp.dtype
                or t.dtype not in KERNEL_DTYPES):
            raise ValueError("sepconv kernels take float32 or bfloat16 "
                             "tensors, all of one type, on one device; got "
                             f"{t.dtype} on {t.device} beside {inp.dtype} on "
                             f"{inp.device}")
    if c != KERNEL_CHANNELS or not 1 <= f <= KERNEL_MAX_TAPS:
        raise ValueError(f"sepconv kernels take C={KERNEL_CHANNELS} and "
                         f"F<={KERNEL_MAX_TAPS}, got C={c}, F={f}")
    for t in maps:
        if t.shape[0] != n or t.shape[2:] != (h, w):
            raise ValueError(f"kernel map of shape {tuple(t.shape)} does not "
                             f"match input {tuple(inp.shape)}")
    return n, c, h, w, f


def _check_cuda(inp: torch.Tensor, *maps: torch.Tensor):
    """Validate what the kernels take on the card; returns (n, c, h, w,
    f)."""
    if inp.device.type != "cuda":
        raise ValueError(f"sepconv kernels take CPU or CUDA tensors, got "
                         f"{inp.device}")
    return _kernel_shapes(inp, *maps)


def _raise_on_error(code: int, name: str):
    if code != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {code}")


def sepconv_forward(inp: torch.Tensor, kv: torch.Tensor, kh: torch.Tensor
                    ) -> torch.Tensor:
    """K1: the forward. Plain version on CPU tensors, kernel on CUDA;
    float32 or bfloat16 (widened, summed in float32, rounded once)."""
    if inp.device.type == "cpu":
        return _widened(sepconv_ref, inp, kv, kh)
    n, c, h, w, f = _check_cuda(inp, kv, kh)
    inp, kv, kh = inp.contiguous(), _build.dense(kv), _build.dense(kh)
    out = torch.empty((n, c, h, w), device=inp.device, dtype=inp.dtype)
    lib = _library()
    fn = (lib.sepconv_forward_bf16 if inp.dtype == torch.bfloat16
          else lib.sepconv_forward)
    with torch.cuda.device(inp.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(
            inp.data_ptr(), kv.data_ptr(), kh.data_ptr(), out.data_ptr(),
            n, c, h, w, f, stream)
    _raise_on_error(code, "sepconv_forward")
    sepconv_forward.launches += 1
    return out


sepconv_forward.launches = 0


def sepconv_grad_kernels(inp: torch.Tensor, g: torch.Tensor, kv: torch.Tensor,
                         kh: torch.Tensor):
    """K2: (gkv, gkh). Plain version on CPU tensors, kernel on CUDA;
    float32 or bfloat16, as K1."""
    if inp.device.type == "cpu":
        return _widened(grad_kernels_ref, inp, g, kv, kh)
    n, c, h, w, f = _check_cuda(inp, kv, kh, g)
    inp, g = inp.contiguous(), _build.dense(g)
    kv, kh = _build.dense(kv), _build.dense(kh)
    if g.shape[1] != c:
        raise ValueError(f"output gradient of shape {tuple(g.shape)} does "
                         f"not match input {tuple(inp.shape)}")
    gkv = torch.empty_like(kv)
    gkh = torch.empty_like(kh)
    lib = _library()
    fn = (lib.sepconv_grad_kernels_bf16 if inp.dtype == torch.bfloat16
          else lib.sepconv_grad_kernels)
    with torch.cuda.device(inp.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(
            inp.data_ptr(), g.data_ptr(), kv.data_ptr(), kh.data_ptr(),
            gkv.data_ptr(), gkh.data_ptr(), n, c, h, w, f, stream)
    _raise_on_error(code, "sepconv_grad_kernels")
    sepconv_grad_kernels.launches += 1
    return gkv, gkh


sepconv_grad_kernels.launches = 0


def reset_launches():
    sepconv_forward.launches = 0
    sepconv_grad_kernels.launches = 0


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

class SepConvFunction(torch.autograd.Function):
    """Forward is K1; backward is K2 for the kernel maps (through
    :class:`SepConvGradKernelsFunction`, so it is differentiable again)
    plus the plain input gradient when the input needs one."""

    @staticmethod
    def forward(ctx, inp, kv, kh):
        ctx.save_for_backward(inp, kv, kh)
        return sepconv_forward(inp, kv, kh)

    @staticmethod
    def backward(ctx, g):
        inp, kv, kh = ctx.saved_tensors
        gkv, gkh = SepConvGradKernelsFunction.apply(inp, g, kv, kh)
        gin = None
        if ctx.needs_input_grad[0]:
            gin = grad_input_ref(g, kv, kh, inp.shape[2], inp.shape[3])
        return gin, gkv, gkh


class SepConvGradKernelsFunction(torch.autograd.Function):
    """(gkv, gkh) = K2(inp, g, kv, kh), differentiable in all four.

    With gw(i,j) = Σ_c g_c·in_c(y+i, x+j), the products against cotangents
    (a_kv, a_kh) sum Σ_ij gw(i,j)·(a_kv_i·kh_j + kv_i·a_kh_j), so

      * ∂/∂g   = K1(inp, a_kv, kh) + K1(inp, kv, a_kh);
      * ∂/∂kv  = Σ_j a_kh_j·gw(i,j) and ∂/∂kh = Σ_i a_kv_i·gw(i,j): both
                 come from one K2 call with (a_kv, a_kh) as its maps;
      * ∂/∂inp = grad_input_ref(g, a_kv, kh) + grad_input_ref(g, kv, a_kh),
                 plain, as the first input gradient.
    """

    @staticmethod
    def forward(ctx, inp, g, kv, kh):
        ctx.save_for_backward(inp, g, kv, kh)
        return sepconv_grad_kernels(inp, g, kv, kh)

    @staticmethod
    def backward(ctx, a_kv, a_kh):
        inp, g, kv, kh = ctx.saved_tensors
        need_in, need_g, need_kv, need_kh = ctx.needs_input_grad
        d_in = d_g = d_kv = d_kh = None
        if need_g:
            d_g = (SepConvFunction.apply(inp, a_kv, kh)
                   + SepConvFunction.apply(inp, kv, a_kh))
        if need_kv or need_kh:
            d_kv, d_kh = SepConvGradKernelsFunction.apply(inp, g, a_kv, a_kh)
        if need_in:
            hp, wp = inp.shape[2], inp.shape[3]
            d_in = (grad_input_ref(g, a_kv, kh, hp, wp)
                    + grad_input_ref(g, kv, a_kh, hp, wp))
        return (d_in, d_g, d_kv if need_kv else None,
                d_kh if need_kh else None)


def sepconv(inp: torch.Tensor, kv: torch.Tensor, kh: torch.Tensor
            ) -> torch.Tensor:
    """inp: (N, C, H+F−1, W+F−1); kv/kh: (N, F, H, W) → (N, C, H, W)."""
    return SepConvFunction.apply(inp, kv, kh)
