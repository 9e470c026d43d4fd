"""Row (H-axis) sharding with a halo exchange, for frames served across
ranks.

Counterpart of ``meta_interpolation_tpu/parallel/spatial.py``. Each rank
of the mesh's spatial axis holds a band of the frame's rows; the halo
exchange pads its band with its neighbours' edge rows, so a conv stack
run on the band sees its full receptive field across the seams.

  * :func:`halo_exchange`: the collective, pad a band from its neighbours;
  * :func:`spatial_sharded_apply`: run a whole-frame apply on this rank's
    band plus the halo and crop the halo off; :func:`gather_rows`
    assembles the frame from the bands.

The apply is exact at every seam for ops whose receptive-field radius is
at most the halo, and approximate at the frame's top and bottom, where
the end bands see their own rows reflected where the whole-frame model
sees its per-layer padding, and for global ops (CAIN's channel-attention
mean sees the band's statistics): JAX's contract, the same class of
approximation as the tiling of oversized frames in evaluation. The exact
row-sharded evaluation (``--spatial_shards``) is not here.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from .mesh import Mesh


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
    edges = torch.cat([x[:, :, :halo], x[:, :, -halo:]], dim=2).contiguous()
    parts = [torch.empty_like(edges) for _ in range(n)]
    dist.all_gather(parts, edges, group=group)
    top = (x[:, :, :halo].flip(2) if idx == 0
           else parts[idx - 1][:, :, halo:])
    bottom = (x[:, :, -halo:].flip(2) if idx == n - 1
              else parts[idx + 1][:, :, :halo])
    return torch.cat([top, x, bottom], dim=2)


def shard_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's band of an (N, C, H, W) frame: the ``spatial_index``-th
    of ``mesh.spatial`` equal bands of rows."""
    h = x.shape[2]
    if h % mesh.spatial:
        raise ValueError(f"{h} rows do not split into {mesh.spatial} bands")
    band = h // mesh.spatial
    return x[:, :, mesh.spatial_index * band:
             (mesh.spatial_index + 1) * band]


def gather_rows(mesh: Mesh, band: torch.Tensor) -> torch.Tensor:
    """The whole (N, C, H, W) frame from every rank's band, on every rank
    of the spatial axis."""
    band = band.contiguous()
    parts = [torch.empty_like(band) for _ in range(mesh.spatial)]
    dist.all_gather(parts, band, group=mesh.spatial_group)
    return torch.cat(parts, dim=2)


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
