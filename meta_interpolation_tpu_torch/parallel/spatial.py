"""Row (H-axis) sharding with a halo exchange, for frames served across
ranks.

Counterpart of ``meta_interpolation_tpu/parallel/spatial.py``, and of the
exact row-sharded evaluation that GSPMD derives for JAX's
``--spatial_shards`` (``parallel/mesh.py`` ``shard_task_spatial_batch``).
Each rank of the mesh's spatial axis holds a band of the frame's rows.

The approximate apply, JAX's contract:

  * :func:`halo_exchange`: the collective, pad a band from its neighbours;
  * :func:`spatial_sharded_apply`: run a whole-frame apply on this rank's
    band plus the halo and crop the halo off; :func:`gather_rows`
    assembles the frame from the bands.

  It is exact at every seam for ops whose receptive-field radius is at
  most the halo, and approximate at the frame's top and bottom, where the
  end bands see their own rows reflected where the whole-frame model sees
  its per-layer padding, and for global ops (CAIN's channel-attention
  mean sees the band's statistics).

The exact row-sharded evaluation and meta-training: the system runs an
episode inside :func:`row_shard`, and each row-aware op of
``models/layers.py`` reads :func:`current` to work on its band of equal
rows, its global offset ``index * rows`` and the frame's ``count *
rows``. Outside the context every op works on whole frames, as before.
The collectives, each an autograd Function whose backward is its adjoint,
so an inner step's gradient is the whole frame's once the ranks'
parameter gradients are summed (:func:`all_reduce_grads`):

  * :func:`halo_rows`: a band with ``halo`` rows of each neighbour, zeros
    past the frame's ends (the op applies its own border rule there);
    each halo row's cotangent goes back to the rank that owns the row
    (:class:`HaloAdjointFunction`);
  * :func:`all_reduce_sum` and :func:`all_reduce_grads`: the sum over
    the bands (a global mean's numerator, the ranks' parts of the support
    gradients in one flat buffer), its backward the sum of the ranks'
    cotangents;
  * :func:`gather_band`: the whole frame from the equal bands, its
    backward this rank's rows of the cotangent (every rank computes the
    same loss on the same gathered frame; :class:`BandSliceFunction`).

Each backward is itself built from these Functions, the adjoint's adjoint
being the collective again, so a backward taken with ``create_graph=True``
(a second-order inner step) stays on the tape, neighbours' parts
included, and the outer gradient differentiates through it. Every rank
runs the same collectives in the same order, forward and backward,
whatever its band holds.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist

from .mesh import Mesh, _flat, _unflat


def halo_exchange(x: torch.Tensor, halo: int, group=None) -> torch.Tensor:
    """Pad an (N, C, H_band, W) band with ``halo`` rows from each
    neighbour on ``group`` (its rank order is the bands' order): (N, C,
    H_band + 2·halo, W). The first and last bands reflect their own edge
    rows at the frame's ends (JAX's ``jnp.flip``).

    One ``all_gather`` of every band's top and bottom rows, a collective
    the gloo and NCCL backends both take on CUDA tensors; each rank keeps
    its neighbours' rows, which is what JAX's two ``ppermute`` calls
    deliver."""
    if not 0 < halo <= x.shape[2]:
        raise ValueError(f"halo {halo} must be in 1..{x.shape[2]} (the "
                         f"band's rows)")
    n = dist.get_world_size(group)
    idx = dist.get_rank(group)
    parts = _edges(x[:, :, :halo], x[:, :, -halo:], RowShard(idx, n, group))
    top = (x[:, :, :halo].flip(2) if idx == 0
           else parts[idx - 1][:, :, halo:])
    bottom = (x[:, :, -halo:].flip(2) if idx == n - 1
              else parts[idx + 1][:, :, :halo])
    return torch.cat([top, x, bottom], dim=2)


def shard_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's band of an (N, C, H, W) frame: the ``spatial_index``-th
    of ``mesh.spatial`` equal bands of rows."""
    return band(x, RowShard.of(mesh))


def gather_rows(mesh: Mesh, band: torch.Tensor) -> torch.Tensor:
    """The whole (N, C, H, W) frame from every rank's band, on every rank
    of the spatial axis."""
    return torch.cat(_all_gather(band, RowShard.of(mesh)), dim=2)


def spatial_sharded_apply(apply_fn: Callable, mesh: Mesh, halo: int = 32
                          ) -> Callable:
    """``apply_fn(params, f0, f1)`` on (N, C, H, W) frames, run on rows
    sharded over the mesh's spatial axis. The function returned takes the
    whole frames (every rank holds them), runs ``apply_fn`` on this
    rank's band plus ``halo`` rows from each neighbour, crops the halo
    off and returns the band's output rows; :func:`gather_rows` assembles
    the frame. See the module's note for where it is exact."""
    def sharded(params, f0: torch.Tensor, f1: torch.Tensor) -> torch.Tensor:
        f0_h = halo_exchange(shard_rows(mesh, f0), halo, mesh.spatial_group)
        f1_h = halo_exchange(shard_rows(mesh, f1), halo, mesh.spatial_group)
        return apply_fn(params, f0_h, f1_h)[:, :, halo:-halo]
    return sharded


# -- the exact row-sharded evaluation --------------------------------------

@dataclasses.dataclass(frozen=True)
class RowShard:
    """This rank's place among the bands: band ``index`` of ``count``, the
    bands' ranks forming ``group`` (the mesh's spatial group; None: the
    whole world)."""
    index: int
    count: int
    group: Any = None

    @classmethod
    def of(cls, mesh: Mesh) -> "RowShard":
        """The mesh's spatial axis, seen from this rank."""
        return cls(mesh.spatial_index, mesh.spatial, mesh.spatial_group)


_CURRENT: contextvars.ContextVar = contextvars.ContextVar("row_shard",
                                                          default=None)


def current() -> Optional[RowShard]:
    """The row shard the ops run under, or None (whole frames)."""
    return _CURRENT.get()


@contextlib.contextmanager
def row_shard(shard):
    """Run the block's row-aware ops on this rank's band: ``shard`` a
    :class:`RowShard` or a mesh (its spatial axis); None runs whole
    frames."""
    if isinstance(shard, Mesh):
        shard = RowShard.of(shard)
    token = _CURRENT.set(shard)
    try:
        yield shard
    finally:
        _CURRENT.reset(token)


def band(x: torch.Tensor, shard: Optional[RowShard] = None) -> torch.Tensor:
    """This rank's band of a whole frame's rows (dim −2), a view."""
    shard = shard or current()
    h = x.shape[-2]
    if h % shard.count:
        raise ValueError(f"{h} rows do not split into {shard.count} bands")
    rows = h // shard.count
    return x[..., shard.index * rows:(shard.index + 1) * rows, :]


def _all_gather(t: torch.Tensor, shard: RowShard):
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(shard.count)]
    dist.all_gather(parts, t, group=shard.group)
    return parts


def _edges(top: torch.Tensor, bottom: torch.Tensor, shard: RowShard):
    """Every rank's (top, bottom) rows, each rank's as one tensor."""
    return _all_gather(torch.cat([top, bottom], dim=-2), shard)


class HaloFunction(torch.autograd.Function):
    """(…, rows, W) band → (…, halo + rows + halo, W): the ``halo`` rows
    of the band above and of the band below, zeros past the frame's ends.
    One ``all_gather`` of every band's edge rows each way."""

    @staticmethod
    def forward(ctx, x, halo, shard):
        if not 0 < halo <= x.shape[-2]:
            raise ValueError(f"halo {halo} must be in 1..{x.shape[-2]} "
                             f"(the band's rows)")
        ctx.halo, ctx.shard = halo, shard
        parts = _edges(x[..., :halo, :], x[..., -halo:, :], shard)
        i, zeros = shard.index, x.new_zeros(
            x.shape[:-2] + (halo, x.shape[-1]))
        above = parts[i - 1][..., halo:, :] if i > 0 else zeros
        below = (parts[i + 1][..., :halo, :] if i < shard.count - 1
                 else zeros)
        return torch.cat([above, x, below], dim=-2)

    @staticmethod
    def backward(ctx, g):
        return HaloAdjointFunction.apply(g, ctx.halo, ctx.shard), None, None


class HaloAdjointFunction(torch.autograd.Function):
    """(…, halo + rows + halo, W) → (…, rows, W), the adjoint of
    :class:`HaloFunction`: the band's own rows, plus the halo rows that
    the neighbours hold of it (their bottom and top halos). Its backward
    is :class:`HaloFunction`."""

    @staticmethod
    def forward(ctx, g, halo, shard):
        ctx.halo, ctx.shard = halo, shard
        i = shard.index
        # each rank's halo rows, sent to their owners: the band above owns
        # this rank's top halo, the band below its bottom one
        parts = _edges(g[..., :halo, :], g[..., -halo:, :], shard)
        gx = g[..., halo:-halo, :].clone()
        if i > 0:
            gx[..., :halo, :] += parts[i - 1][..., halo:, :]
        if i < shard.count - 1:
            gx[..., -halo:, :] += parts[i + 1][..., :halo, :]
        return gx

    @staticmethod
    def backward(ctx, gg):
        return HaloFunction.apply(gg, ctx.halo, ctx.shard), None, None


def halo_rows(x: torch.Tensor, halo: int,
              shard: Optional[RowShard] = None) -> torch.Tensor:
    """This rank's band with ``halo`` rows of each neighbour's band, zeros
    past the frame's ends; differentiable (:class:`HaloFunction`)."""
    return HaloFunction.apply(x, halo, shard or current())


class AllReduceTensorsFunction(torch.autograd.Function):
    """Each of a list of tensors summed over the bands' ranks, read by
    every rank's band, through one flat buffer: one SUM all-reduce. Its
    own adjoint: its backward sums the ranks' cotangents of all the
    tensors at once, through itself, so it is twice differentiable (a
    slice of the flat buffer a tensor would give each tensor's cotangent
    the whole buffer's size, filled with zeros)."""

    @staticmethod
    def forward(ctx, shard, *tensors):
        ctx.shard = shard
        flat = _flat(tensors)
        dist.all_reduce(flat, group=shard.group)
        return tuple(_unflat(flat, tensors))

    @staticmethod
    def backward(ctx, *grads):
        return (None,) + tuple(AllReduceTensorsFunction.apply(ctx.shard,
                                                               *grads))


def all_reduce_sum(x: torch.Tensor,
                   shard: Optional[RowShard] = None) -> torch.Tensor:
    """Σ over the bands' ranks of ``x``, differentiable."""
    return AllReduceTensorsFunction.apply(shard or current(), x)[0]


class GatherBandFunction(torch.autograd.Function):
    """The whole frame from every rank's equal band (rows, dim −2); its
    backward takes this rank's rows of the cotangent, which every rank
    computes alike from the same gathered frame
    (:class:`BandSliceFunction`)."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return torch.cat(_all_gather(x, shard), dim=-2)

    @staticmethod
    def backward(ctx, g):
        return BandSliceFunction.apply(g, ctx.shard), None


class BandSliceFunction(torch.autograd.Function):
    """This rank's band of a whole frame that every rank holds alike, the
    adjoint of :class:`GatherBandFunction`; its backward gathers the
    bands' cotangents into the whole frame's. (A plain slice would pad its
    cotangent with zeros: where the loss couples rows, as a perceptual
    term does, the second order would then lose the other bands' part.)"""

    @staticmethod
    def forward(ctx, g, shard):
        ctx.shard = shard
        return band(g, shard).clone()

    @staticmethod
    def backward(ctx, gg):
        return GatherBandFunction.apply(gg, ctx.shard), None


def gather_band(x: torch.Tensor,
                shard: Optional[RowShard] = None) -> torch.Tensor:
    """The whole frame from the bands, on every rank; differentiable."""
    return GatherBandFunction.apply(x, shard or current())


def all_reduce_grads(grads: Sequence[torch.Tensor],
                     shard: Optional[RowShard] = None):
    """The ranks' parameter gradients summed over the bands: one SUM
    all-reduce of one flat buffer. Each rank's gradient is its band's part
    of the whole frame's, so the sum is the whole frame's. Differentiable
    (:class:`AllReduceTensorsFunction`): a second-order inner step's
    gradient, taken with ``create_graph=True``, keeps the sum on the
    tape."""
    shard = shard or current()
    grads = list(grads)
    if not grads:
        return grads
    return list(AllReduceTensorsFunction.apply(shard, *grads))
