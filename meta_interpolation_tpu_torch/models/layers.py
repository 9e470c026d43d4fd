"""The layers of the ported models, in NCHW.

Counterparts of ``meta_interpolation_tpu/models/layers.py``, which works
in NHWC with HWIO kernels; here activations are NCHW and conv weights
OIHW (:func:`conv3x3` builds a ``nn.Conv2d``, whose state-dict names the
weight bridge maps onto the JAX ``kernel``/``bias`` leaves). Transposed
convs are ``nn.ConvTranspose2d`` (weight (in, out, kh, kw)), and batch norm
is :class:`EvalBatchNorm2d`, which always normalises with its stored
statistics.

Inside ``parallel/spatial.row_shard`` (the exact ``--spatial_shards``
evaluation) the row-aware ops work on this rank's band of rows: the
convolutions of :class:`Conv2d`, :func:`conv_as_input` and
:func:`band_conv` (a halo from the neighbouring bands, the conv's own
border rule at the frame's top and bottom), :func:`upsample_bilinear`
(source rows from the frame's global coordinates, either
``align_corners``) and :func:`global_avg_pool` (the bands' sums
all-reduced). :func:`avg_pool` and :func:`max_pool` need no change: they
are local while every band has even rows. Outside the context they are
the whole-frame ops.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import spatial


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


def band_conv(x: torch.Tensor, weight: torch.Tensor,
              bias: Optional[torch.Tensor], pad: int,
              reflect: bool = False) -> torch.Tensor:
    """A stride-1 (2·pad + 1)-square conv of this rank's band of rows
    (``spatial.current()``), as the whole frame's conv computes those rows:
    ``pad`` rows of each neighbouring band, then the conv's own border
    rule past the frame's top and bottom (zeros, or with ``reflect`` the
    band's own rows mirrored, the edge not repeated) and on the columns.
    The zero-padded conv pads its halo band on all sides, as the whole
    frame's conv pads the frame, and drops the ``pad`` rows it computes
    past each halo: padded in its columns only, cuDNN's heuristics took
    an algorithm with a 4 GiB workspace for SuperSloMo's 7×7 convs at
    256×448 on the card."""
    shard = spatial.current()
    xh = spatial.halo_rows(x, pad, shard)
    if not reflect:
        return F.conv2d(xh, weight, bias, padding=pad)[..., pad:-pad, :]
    if x.shape[-2] <= pad:
        raise ValueError(f"a reflect-padded band needs more than {pad} "
                         f"rows, got {x.shape[-2]}")
    last = shard.index == shard.count - 1
    top = (x[..., 1:pad + 1, :].flip(-2) if shard.index == 0
           else xh[..., :pad, :])
    bottom = x[..., -pad - 1:-1, :].flip(-2) if last else xh[..., -pad:, :]
    xh = torch.cat([top, x, bottom], dim=-2)
    return F.conv2d(F.pad(xh, (pad, pad, 0, 0), mode="reflect"), weight,
                    bias)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` (zero padding, stride 1), row-aware inside a row
    shard (:func:`band_conv`); its state dict is ``nn.Conv2d``'s."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if spatial.current() is None or self.padding[0] == 0:
            return super().forward(x)
        return band_conv(x, self.weight, self.bias, self.padding[0])


def xavier_conv(in_ch: int, out_ch: int, k: int,
                generator: Optional[torch.Generator] = None) -> nn.Conv2d:
    """k×k stride-1 conv, padding k // 2, xavier-uniform weight and zero
    bias (``meta_interpolation_tpu/models/cain.py:34`` ``_xavier_conv``);
    row-aware (:class:`Conv2d`)."""
    conv = Conv2d(in_ch, out_ch, k, padding=k // 2)
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
    float32. Inside a row shard a zero-padded stride-1 conv runs on the
    band (:func:`band_conv`)."""
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    weight = conv.weight.to(x.dtype)
    if spatial.current() is not None and conv.padding[0]:
        return band_conv(x, weight, bias, conv.padding[0])
    return F.conv2d(x, weight, bias, conv.stride, conv.padding,
                    conv.dilation, conv.groups)


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


class PaddedGridBands:
    """``grid_rows`` and ``row_bands`` of a model that reflect-pads its
    frames to a multiple of ``MULTIPLE`` rows (:func:`pad_to_multiple`)
    and halves them with ``POOLS`` 2×2 pools: its grid runs exactly on
    row bands (``parallel/spatial.row_shard``) when it splits into equal
    bands whose rows every pool halves evenly."""
    MULTIPLE: int
    POOLS: int

    @classmethod
    def grid_rows(cls, h: int) -> int:
        """The rows of the padded grid of a frame of ``h`` rows."""
        return h + (-h) % cls.MULTIPLE

    def row_bands(self, h: int, shards: int) -> bool:
        """Whether a frame of ``h`` rows runs exactly in ``shards`` row
        bands."""
        return self.grid_rows(h) % (shards * 2 ** self.POOLS) == 0


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
    """NCHW → NC11, the spatial mean (reference AdaptiveAvgPool2d(1)); in
    a row shard the whole frame's, from the bands' sums."""
    shard = spatial.current()
    if shard is None:
        return x.mean(dim=(-2, -1), keepdim=True)
    total = spatial.all_reduce_sum(x.sum(dim=(-2, -1), keepdim=True), shard)
    return total / (x.shape[-2] * shard.count * x.shape[-1])


def sub_mean(x: torch.Tensor):
    """Subtract each image's per-channel spatial mean (model_utils.py
    :11-15), of the whole frame ``x``. Returns (x − mean, mean)."""
    mean = x.mean(dim=(-2, -1), keepdim=True)
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
    shard = spatial.current()
    if shard is not None:
        return _band_upsample(x, scale, shard, align_corners)
    return F.interpolate(x, scale_factor=scale, mode="bilinear",
                         align_corners=align_corners)


def _band_upsample(x: torch.Tensor, scale: int, shard: "spatial.RowShard",
                   align_corners: bool) -> torch.Tensor:
    """This rank's band of the bilinear ×scale upsample of the whole frame,
    from its band and one halo row each way: output row Y reads the input
    at src = Y·(H_in − 1)/(H_out − 1) with align_corners, else at
    max((Y + 0.5)/s − 0.5, 0) (global rows, in ``F.interpolate``'s
    arithmetic), which for the output band [s·a, s·b) lies in [a − 1, b];
    at the frame's ends the clamps, not the halo's zeros, give the value.
    The columns are ``F.interpolate``'s (its rows an identity at a scale
    of 1)."""
    rows, w = x.shape[-2], x.shape[-1]
    h_in = rows * shard.count
    h_out, a = h_in * scale, shard.index * rows
    xh = F.interpolate(spatial.halo_rows(x, 1, shard),
                       size=(rows + 2, w * scale), mode="bilinear",
                       align_corners=align_corners)
    # F.interpolate's index arithmetic: float32, or float64 for float64
    opmath = torch.float64 if x.dtype == torch.float64 else torch.float32
    y = torch.arange(a * scale, (a + rows) * scale, device=x.device,
                     dtype=opmath)
    if align_corners:
        src = y * torch.tensor((h_in - 1) / (h_out - 1), dtype=opmath)
    else:
        src = ((y + 0.5) * torch.tensor(1.0 / scale, dtype=opmath)
               - 0.5).clamp(min=0.0)
    y0 = src.floor().long().clamp(max=h_in - 1)
    lam = (src - y0).to(x.dtype)[:, None]
    y1 = torch.where(y0 < h_in - 1, y0 + 1, y0)
    # global row r sits at r − (a − 1) of the halo band
    top = xh.index_select(-2, y0 - (a - 1))
    bottom = xh.index_select(-2, y1 - (a - 1))
    return top * (1 - lam) + bottom * lam


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
