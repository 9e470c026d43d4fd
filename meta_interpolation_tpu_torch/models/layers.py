"""The layers of the ported models, in NCHW.

Counterparts of ``meta_interpolation_tpu/models/layers.py``, which works
in NHWC with HWIO kernels; here activations are NCHW and conv weights
OIHW (:func:`conv3x3` builds a ``nn.Conv2d``, whose state-dict names the
weight bridge maps onto the JAX ``kernel``/``bias`` leaves). Transposed
convs are ``nn.ConvTranspose2d`` (weight (in, out, kh, kw)), and batch norm
is :class:`EvalBatchNorm2d`, which always normalises with its stored
statistics.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn


def full_float32() -> None:
    """Turn TF32 off for cuDNN convolutions and cuBLAS matmuls: on the card
    they default to it, which keeps ~3 decimal digits. The port computes in
    full float32; every model's forward calls this. bf16 matmuls reduce in
    float32 too, as the JAX package asks with ``preferred_element_type``
    (``models/layers.py:121``): cuBLAS may otherwise reduce them in
    reduced precision."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def xavier_conv(in_ch: int, out_ch: int, k: int,
                generator: Optional[torch.Generator] = None) -> nn.Conv2d:
    """k×k stride-1 conv, padding k // 2, xavier-uniform weight and zero
    bias (``meta_interpolation_tpu/models/cain.py:34`` ``_xavier_conv``)."""
    conv = nn.Conv2d(in_ch, out_ch, k, padding=k // 2)
    bound = math.sqrt(6.0 / ((in_ch + out_ch) * k * k))
    with torch.no_grad():
        conv.weight.uniform_(-bound, bound, generator=generator)
        conv.bias.zero_()
    return conv


def conv3x3(in_ch: int, out_ch: int,
            generator: Optional[torch.Generator] = None) -> nn.Conv2d:
    """3×3 :func:`xavier_conv`."""
    return xavier_conv(in_ch, out_ch, 3, generator)


def conv_as_input(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv(x)`` with its weight and bias cast to ``x``'s type, as every
    JAX conv casts its kernel (``models/layers.py:226``, ``:250``): where
    a layer before it promoted a bf16 activation to float32, it runs in
    float32."""
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    return F.conv2d(x, conv.weight.to(x.dtype), bias, conv.stride,
                    conv.padding, conv.dilation, conv.groups)


def torch_default_init_(conv: nn.Module,
                        generator: Optional[torch.Generator] = None):
    """``nn.Conv2d``'s own init, drawn from ``generator``: weight and bias
    uniform in ±1/√fan_in (kaiming_uniform with a = √5)."""
    fan_in = conv.weight[0].numel()
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        conv.weight.uniform_(-bound, bound, generator=generator)
        if conv.bias is not None:
            conv.bias.uniform_(-bound, bound, generator=generator)
    return conv


def normal_init_(conv: nn.Module, std: float,
                 generator: Optional[torch.Generator] = None):
    """Weight normal(0, std), bias zero."""
    with torch.no_grad():
        conv.weight.normal_(0.0, std, generator=generator)
        if conv.bias is not None:
            conv.bias.zero_()
    return conv


class EvalBatchNorm2d(nn.Module):
    """Batch norm with stored statistics only (the JAX package's
    ``hourglass._bn``, and with ``affine`` its frozen ``batch_norm_init`` /
    ``batch_norm_apply``, ``models/layers.py:527-543``):
    ``(x − running_mean)/√(running_var + eps)``, then ``·weight + bias``
    when affine. Unlike ``nn.BatchNorm2d`` it never switches to batch
    statistics, whatever ``self.training`` says. The statistics are
    buffers, so ``named_parameters()`` (the meta-parameters) never holds
    them; the affine pair are parameters. Names follow
    ``nn.BatchNorm2d``'s state dict, so reference weights load."""

    def __init__(self, ch: int, affine: bool = False, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))
        self.weight = nn.Parameter(torch.ones(ch)) if affine else None
        self.bias = nn.Parameter(torch.zeros(ch)) if affine else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the statistics and the affine pair in the activation's type, as
        # JAX casts them (models/layers.py:541-543): a float32 buffer would
        # promote a bf16 activation
        cast = [None if t is None else t.to(x.dtype) for t in (
            self.running_mean, self.running_var, self.weight, self.bias)]
        return F.batch_norm(x, *cast, training=False, eps=self.eps)


def replicate_pad(x: torch.Tensor, pad: Union[int, Sequence[int]]
                  ) -> torch.Tensor:
    """Edge-replicate pad; ``pad`` is an int or (left, right, top, bottom),
    the order ``F.pad`` takes."""
    if isinstance(pad, int):
        pad = (pad, pad, pad, pad)
    return F.pad(x, tuple(pad), mode="replicate")


def _reflect_index(size: int, before: int, after: int,
                   device: torch.device) -> torch.Tensor:
    """Source index of each padded position along one axis, as
    ``jnp.pad(mode="reflect")`` picks it: the reflection (edge not
    repeated) continues periodically, so a pad may exceed the size."""
    pos = torch.arange(-before, size + after, device=device)
    if size == 1:
        return torch.zeros_like(pos)
    period = 2 * (size - 1)
    pos = pos.remainder(period)
    return torch.where(pos >= size, period - pos, pos)


def reflect_pad(x: torch.Tensor, pad: Union[int, Sequence[int]]
                ) -> torch.Tensor:
    """Reflection pad; ``pad`` is an int or (left, right, top, bottom).
    Unlike ``F.pad(mode="reflect")``, a pad as wide as the dimension or
    wider reflects again, as ``jnp.pad`` does."""
    if isinstance(pad, int):
        pad = (pad, pad, pad, pad)
    left, right, top, bottom = pad
    h, w = x.shape[-2], x.shape[-1]
    x = x.index_select(-2, _reflect_index(h, top, bottom, x.device))
    return x.index_select(-1, _reflect_index(w, left, right, x.device))


def _fold_reflection(g: torch.Tensor, p: int, dim: int) -> torch.Tensor:
    """The cotangent of a reflection pad by ``p`` on both ends of ``dim``:
    the centre, plus each border mirrored onto the ``p`` values next to its
    edge (the edge itself is not repeated)."""
    n = g.shape[dim] - 2 * p
    spec = (lambda a, b: (a, b)) if dim == -1 else (
        lambda a, b: (0, 0, a, b))
    lead = g.narrow(dim, 0, p).flip(dim)
    tail = g.narrow(dim, n + p, p).flip(dim)
    return (g.narrow(dim, p, n) + F.pad(lead, spec(1, n - p - 1))
            + F.pad(tail, spec(n - p - 1, 1)))


class ReflectPadFunction(torch.autograd.Function):
    """``F.pad(x, (p,) * 4, mode="reflect")`` whose backward adds the
    borders' cotangents onto the mirrored rows and columns in a fixed
    order; twice differentiable. On the card aten's backward of the pad
    adds with atomics, in an order that changes from run to run, and
    refuses to run under ``torch.use_deterministic_algorithms``."""

    @staticmethod
    def forward(ctx, x, p):
        ctx.p = p
        return F.pad(x, (p,) * 4, mode="reflect")

    @staticmethod
    def backward(ctx, g):
        p = ctx.p
        return _fold_reflection(_fold_reflection(g, p, -1), p, -2), None


def reflect_pad_same(x: torch.Tensor, p: int) -> torch.Tensor:
    """``F.pad(x, (p,) * 4, mode="reflect")`` (a pad narrower than the
    map); under ``torch.use_deterministic_algorithms`` the backward is
    :class:`ReflectPadFunction`'s."""
    if torch.are_deterministic_algorithms_enabled():
        return ReflectPadFunction.apply(x, p)
    return F.pad(x, (p,) * 4, mode="reflect")


def pad_to_multiple(x: torch.Tensor, multiple: int = 128):
    """Reflect-pad H and W up to the next multiple, split evenly with the
    odd pixel at the bottom/right. Returns (padded, (left, right, top,
    bottom)); crop back with :func:`unpad`."""
    h, w = x.shape[-2], x.shape[-1]
    ph, pw = (-h) % multiple, (-w) % multiple
    pads = (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2)
    if ph == 0 and pw == 0:
        return x, pads
    return reflect_pad(x, pads), pads


def unpad(x: torch.Tensor, pads: Sequence[int]) -> torch.Tensor:
    left, right, top, bottom = pads
    h, w = x.shape[-2], x.shape[-1]
    return x[..., top:h - bottom, left:w - right]


def pixel_shuffle(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Depth to space for ``scale`` ≥ 1, space to depth for ``scale`` < 1
    (JAX ``layers.pixel_shuffle``, reference model_utils.py:202-228). Both
    take the reference's channel order, (C, s_h, s_w) with the channel
    outermost, which is ``F.pixel_shuffle`` / ``F.pixel_unshuffle``'s."""
    if scale >= 1:
        return F.pixel_shuffle(x, int(scale))
    return F.pixel_unshuffle(x, int(round(1.0 / scale)))


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """NCHW → NC11, the spatial mean (reference AdaptiveAvgPool2d(1))."""
    return x.mean(dim=(-2, -1), keepdim=True)


def sub_mean(x: torch.Tensor):
    """Subtract each image's per-channel spatial mean (model_utils.py
    :11-15). Returns (x − mean, mean)."""
    mean = global_avg_pool(x)
    return x - mean, mean


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)


def avg_pool(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    return F.avg_pool2d(x, window)


def max_pool(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    return F.max_pool2d(x, window)


def resize_bilinear(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Bilinear resize to ``size`` (H, W), align_corners=False: what the
    JAX package's dense-matrix ``resize_bilinear`` computes."""
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=False)


def upsample_bilinear(x: torch.Tensor, scale: int = 2,
                      align_corners: bool = False) -> torch.Tensor:
    return F.interpolate(x, scale_factor=scale, mode="bilinear",
                         align_corners=align_corners)


class Upsample(nn.Module):
    """Bilinear ×scale upsample as a module, so it holds an index in an
    ``nn.Sequential`` as the reference's ``nn.Upsample`` does."""

    def __init__(self, scale: int = 2, align_corners: bool = True):
        super().__init__()
        self.scale = scale
        self.align_corners = align_corners

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upsample_bilinear(x, self.scale, self.align_corners)


def meta_batch_norm(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, running_mean: torch.Tensor,
                    running_var: torch.Tensor, num_step: int = 0,
                    per_step: bool = True, momentum: float = 0.1,
                    eps: float = 1e-5):
    """The per-step meta batch norm (JAX ``meta_batch_norm_apply``,
    ``models/layers.py:574-615``; reference MetaBatchNormLayer,
    model_utils.py:482-525), NCHW. Normalises with the batch's statistics
    (biased variance), then ``·weight + bias`` (the caller picks the
    per-step affine row or an adapted pair). Returns ``(out,
    (running_mean, running_var))``: the running statistics updated with
    ``momentum`` and the unbiased variance, at row ``num_step`` when
    ``per_step`` (rows (S, C)), else whole (C,). The statistics never carry
    a gradient."""
    var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
    shape = (1, -1, 1, 1)
    # the affine pair at float32 or wider: JAX multiplies by its float32
    # masters uncast (models/layers.py:599), so a bf16 activation leaves
    # the layer in float32
    weight, bias = (t.to(torch.promote_types(t.dtype, torch.float32))
                    for t in (weight, bias))
    out = ((x - mean.view(shape)) * torch.rsqrt(var + eps).view(shape)
           * weight.view(shape) + bias.view(shape))
    n = x.numel() // x.shape[1]
    with torch.no_grad():
        mean, var = mean.detach(), var.detach() * (n / max(n - 1, 1))
        if per_step:
            new_mean, new_var = running_mean.clone(), running_var.clone()
            new_mean[num_step] = ((1 - momentum) * running_mean[num_step]
                                  + momentum * mean)
            new_var[num_step] = ((1 - momentum) * running_var[num_step]
                                 + momentum * var)
        else:
            new_mean = (1 - momentum) * running_mean + momentum * mean
            new_var = (1 - momentum) * running_var + momentum * var
    return out, (new_mean, new_var)


def meta_batch_norm_init(ch: int, num_steps: int, per_step: bool = True,
                         device=None):
    """The statistics of :func:`meta_batch_norm`: rows (S, C) of zero means
    and unit variances, or the flat (C,) variant, whose variance starts at
    zeros (a reference quirk the JAX package keeps,
    ``meta_batch_norm_init``)."""
    if per_step:
        return (torch.zeros(num_steps, ch, device=device),
                torch.ones(num_steps, ch, device=device))
    return (torch.zeros(ch, device=device), torch.zeros(ch, device=device))
