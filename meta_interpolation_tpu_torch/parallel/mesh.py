"""Episode (task) parallelism over PyTorch ranks.

Counterpart of ``meta_interpolation_tpu/parallel/mesh.py``. The JAX
package lays its devices out as a (task, spatial) mesh in one process and
lets GSPMD partition the episode. Here every rank is a process with a
device of its own (``torchrun``, one process a card), and the collectives
are explicit:

  * the task axis shards the episode batch, pure data parallelism over
    scenes. Every rank builds the same global batch (one seed, one
    shuffle) and takes its slice (:func:`shard_task_batch`), runs whole
    inner loops on its own tasks, and one all-reduce sums the outer
    gradient over the task axis (:func:`all_reduce_grads`). Per-task
    results are gathered back into global task order
    (:func:`gather_tasks`), so every rank sees the global batch's
    predictions, losses and metrics, as JAX's global arrays are seen.
  * the spatial axis: ranks that share a task coordinate hold the same
    tasks (replicated over the spatial axis, JAX's task-only placement).
    Under ``--spatial_shards`` they also split each frame's rows for the
    exact row-sharded evaluation and training
    (:func:`shard_task_spatial_batch`, the bands' ops in
    ``parallel/spatial.py``); a training gradient is then summed over
    every rank of the mesh (:func:`all_reduce_grads` with ``rows``).

Rank ``r`` of a mesh sits at task ``r // spatial``, spatial ``r %
spatial``, JAX's device array reshaped to the mesh. A multi-node run
needs nothing more: every rank reads the whole global batch and slices
it, as JAX does within one process, so JAX's multi-host placement (each
host holding only its slice, and no replicated fallback) has no
counterpart here.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (task, spatial) mesh of ranks, seen from one of them.

    ``ranks``: the global ranks of the mesh in mesh order; ``rank``: this
    process's index among them. The process groups: ``task_group`` holds
    the ranks at this rank's spatial coordinate (the gradient's
    all-reduce and the task gathers run over it), ``spatial_group`` those
    at its task coordinate, ``group`` the whole mesh. A group is None
    where no process group is initialized (a mesh built for its
    arithmetic alone)."""
    task: int
    spatial: int
    rank: int = 0
    ranks: Tuple[int, ...] = ()
    task_group: Any = None
    spatial_group: Any = None
    group: Any = None

    @property
    def task_index(self) -> int:
        return self.rank // self.spatial

    @property
    def spatial_index(self) -> int:
        return self.rank % self.spatial

    def __str__(self):
        return (f"Mesh(task={self.task}, spatial={self.spatial}, "
                f"ranks={list(self.ranks)})")


def make_mesh(mesh_shape: Optional[str] = None,
              world_size: Optional[int] = None, rank: Optional[int] = None,
              ranks: Optional[Sequence[int]] = None) -> Optional[Mesh]:
    """Build the (task, spatial) mesh over ``ranks`` (default: every rank
    of the world). ``mesh_shape``: "8" is 8-way task parallel, "4x2"
    4-way task by 2-way spatial, None every rank on the task axis; the
    product must be the number of ranks (JAX ``make_mesh``).

    With a process group initialized, ``world_size`` and ``rank`` come
    from it, and every rank of the world must call this, in the same
    order, since each group of the mesh is created by all of them
    (``dist.new_group``); a rank outside ``ranks`` gets None. Without
    one, the mesh is plain arithmetic: give ``world_size`` (and the
    ``rank`` to see it from)."""
    live = dist.is_available() and dist.is_initialized()
    if live:
        world_size, rank = dist.get_world_size(), dist.get_rank()
    elif world_size is None:
        raise ValueError("make_mesh: no process group; give world_size")
    rank = 0 if rank is None else rank
    ranks = tuple(range(world_size) if ranks is None else ranks)
    if mesh_shape:
        dims = tuple(int(x) for x in mesh_shape.lower().split("x"))
        if len(dims) == 1:
            dims = (dims[0], 1)
        if len(dims) != 2:
            raise ValueError(f"mesh {dims}: give TASK or TASKxSPATIAL")
    else:
        dims = (len(ranks), 1)
    if dims[0] * dims[1] != len(ranks):
        raise ValueError(f"mesh {dims} != {len(ranks)} devices")
    task, spatial = dims
    grid = np.asarray(ranks).reshape(task, spatial)
    groups: Dict[str, Any] = {}
    if live:
        whole = (None if len(ranks) == world_size
                 else dist.new_group(list(ranks)))
        # every rank creates every group, in one order
        for s in range(spatial):
            g = dist.new_group(grid[:, s].tolist())
            if rank in grid[:, s]:
                groups["task_group"] = g
        for t in range(task):
            g = dist.new_group(grid[t].tolist())
            if rank in grid[t]:
                groups["spatial_group"] = g
        groups["group"] = whole
    if rank not in ranks:
        return None
    return Mesh(task, spatial, ranks.index(rank), ranks, **groups)


def validate_train_batch(mesh: Optional[Mesh], batch_size: int) -> None:
    """Reject a configured training batch the task axis does not divide
    (JAX :58-76): every training iteration would otherwise fall back to
    the replicated placement, every rank running the whole batch. The
    spatial axis takes no share of the batch: the ranks along it hold the
    same tasks and split their rows."""
    if mesh is None:
        return
    axis = mesh.task
    if axis > 1 and batch_size % axis:
        raise ValueError(
            f"--batch_size {batch_size} is not divisible by the mesh task "
            f"axis ({axis}); every training batch would fall back to "
            f"replicated placement. Use a batch size that is a multiple "
            f"of {axis} or shrink the task axis (--mesh_shape).")


def shard_task_batch(mesh: Mesh, frames):
    """This rank's tasks of a global (B, T, H, W, C) batch: the ``task
    _index``-th of ``mesh.task`` equal slices. When the task axis does not
    divide B (the tail partial batch of an evaluation epoch) every rank
    keeps the whole batch, JAX's replicated fallback (:79-92): exact, just
    without task parallelism for that batch. Training never takes it: the
    loader drops the tail when the task axis is above 1, and
    :func:`validate_train_batch` refuses an undividable batch size."""
    b = len(frames)
    if mesh.task == 1 or b % mesh.task:
        return frames
    per = b // mesh.task
    return frames[mesh.task_index * per:(mesh.task_index + 1) * per]


def shard_task_spatial_batch(mesh: Mesh, frames, splits) -> Tuple[Any, bool]:
    """This rank's tasks of a global (B, T, H, W, C) batch
    (:func:`shard_task_batch`), and whether the model runs them on row
    bands over the spatial axis: the counterpart of JAX's
    ``shard_task_spatial_batch`` (:95-112). Every rank keeps the whole
    frames; the model cuts its band after its whole-frame preparation.
    ``splits(h, shards)``: whether the model's grid of a frame of ``h``
    rows splits into ``shards`` bands it runs exactly (JAX's ``h %
    spatial``); where it does not, the batch runs unsharded on every rank
    of the spatial axis. The decision reads global shapes only, so every
    rank makes the same."""
    rows = mesh.spatial > 1 and bool(splits(np.shape(frames)[2],
                                            mesh.spatial))
    return shard_task_batch(mesh, frames), rows


def _flat(tensors):
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat(flat, like):
    out, offset = [], 0
    for t in like:
        out.append(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()
    return out


def replicate_params(mesh: Mesh, params: Dict[str, Dict[str, torch.Tensor]]):
    """Broadcast the meta-parameters (a dict of groups of tensors) from
    the mesh's first rank to all of its ranks, in place, as one flat
    buffer in a fixed order of groups and keys (JAX replicates them with a
    sharding)."""
    keys = [(g, k) for g in sorted(params) for k in sorted(params[g])]
    if len(mesh.ranks) < 2 or not keys:
        return params
    tensors = [params[g][k] for g, k in keys]
    flat = _flat(tensors)
    dist.broadcast(flat, src=mesh.ranks[0], group=mesh.group)
    with torch.no_grad():
        for t, v in zip(tensors, _unflat(flat, tensors)):
            t.copy_(v)
    return params


def all_reduce_grads(mesh: Mesh, grads: Dict[str, Dict[str, torch.Tensor]],
                     trainable: Dict[str, Dict[str, bool]],
                     rows: bool = False):
    """Sum the trainable outer gradients over the task axis: one SUM
    all-reduce of one flat buffer, in a fixed order of groups and keys.
    Each rank's episode divided its tasks' losses by the global task
    count, so the sum is the gradient of the global task mean, the
    gradient XLA's psum gives JAX. With ``rows`` (the episode ran on row
    bands) each rank's gradient is also only its band's part, and the sum
    runs over every rank of the mesh, task × spatial. Returns ``grads``
    with the trainable entries replaced."""
    keys = [(g, k) for g in sorted(grads) for k in sorted(grads[g])
            if trainable[g][k]]
    ranks = len(mesh.ranks) if rows else mesh.task
    if ranks == 1 or not keys:
        return grads
    tensors = [grads[g][k] for g, k in keys]
    flat = _flat(tensors)
    dist.all_reduce(flat, group=mesh.group if rows else mesh.task_group)
    out = {g: dict(tree) for g, tree in grads.items()}
    for (g, k), v in zip(keys, _unflat(flat, tensors)):
        out[g][k] = v
    return out


def gather_tasks(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """All-gather a per-task tensor (this rank's tasks on dim 0) over the
    task axis, in global task order."""
    if mesh.task == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.task)]
    dist.all_gather(parts, x, group=mesh.task_group)
    return torch.cat(parts)


def init_distributed(device: str = "cuda") -> torch.device:
    """Join the process group that ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``) and return this rank's device. The backend by rule:
    gloo on the CPU; NCCL when every rank of the node has a card of its
    own (the rank takes ``cuda:LOCAL_RANK``); gloo when ranks share cards
    (``cuda:LOCAL_RANK % cards``), since NCCL refuses two ranks on one
    device. A process group already initialized is joined as it is."""
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        rank = int(os.environ["RANK"])
        world = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if device == "cpu":
        backend, dev = "gloo", torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but no CUDA device is available; "
                "pass --device cpu to run the ranks on the CPU")
        cards = torch.cuda.device_count()
        backend = "nccl" if cards >= local_world else "gloo"
        dev = torch.device("cuda", local % cards)
        # the kernels launch on the current device
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=world)
    print(f"[dist] rank {rank}/{world}: backend "
          f"{dist.get_backend()} on {dev}"
          + (f" ({local_world} ranks on {torch.cuda.device_count()} "
             f"card(s) of this node)" if dev.type == "cuda" else ""),
          flush=True)
    return dev


def is_rank0() -> bool:
    """Whether this process writes: rank 0, or a process with no group."""
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def log(*args, **kwargs) -> None:
    """``print`` on the writing rank only."""
    if is_rank0():
        print(*args, **kwargs)


def barrier(mesh: Optional[Mesh]) -> None:
    """Wait for every rank of ``mesh`` (nothing without one)."""
    if mesh is not None and len(mesh.ranks) > 1:
        dist.barrier(group=mesh.group)
