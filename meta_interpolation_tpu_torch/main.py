"""CLI entry point.

    python -m meta_interpolation_tpu_torch.main --model cain --mode val \
        --dataset synthetic --loss 1*L1 --optimizer Adam --metasgd \
        --inner_lr 1e-5 --number_of_evaluation_steps_per_iter 1 \
        --val_batch_size 1 [--viz] [--device cpu]
    python -m meta_interpolation_tpu_torch.main --model cain --mode train \
        --dataset synthetic --loss 1*L1 --optimizer Adam --batch_size 8 \
        --val_batch_size 1 --inner_lr 1e-5 --outer_lr 1e-5 \
        --number_of_training_steps_per_iter 1 \
        --number_of_evaluation_steps_per_iter 1 --metasgd [--second_order] \
        [--device cpu]
    python -m meta_interpolation_tpu_torch.main --model cain --mode test \
        --dataset test --data_root <frames> --img_fmt png \
        --number_of_evaluation_steps_per_iter 1 [--device cpu]
    python -m meta_interpolation_tpu_torch.main --model sepconv --mode val \
        --dataset synthetic --optimizer Adamax --metasgd --inner_lr 1e-5 \
        --number_of_evaluation_steps_per_iter 3 --val_batch_size 1 \
        --loss 1*L1 [--device cpu]
    python -m meta_interpolation_tpu_torch.main --model sepconv --mode train \
        --dataset synthetic --loss 1*L1 --optimizer Adamax --batch_size 3 \
        --val_batch_size 1 --inner_lr 1e-5 --outer_lr 1e-5 \
        --number_of_training_steps_per_iter 3 \
        --number_of_evaluation_steps_per_iter 3 --metasgd [--second_order] \
        [--use_multi_step_loss_optimization] [--resume] [--device cpu]
    python -m meta_interpolation_tpu_torch.main --model rrin --mode val \
        --dataset synthetic --optimizer Adam --inner_lr 1e-5 --loss 1*L1 \
        --number_of_training_steps_per_iter 0 \
        --number_of_evaluation_steps_per_iter 1 --fast_warp_range 8 \
        [--device cpu]
    python -m meta_interpolation_tpu_torch.main --model superslomo \
        --mode val --dataset synthetic --loss 1*Super --optimizer Adam \
        --metasgd --inner_lr 1e-5 --number_of_training_steps_per_iter 1 \
        --number_of_evaluation_steps_per_iter 1 --fast_warp_range 8 \
        [--device cpu]
    python -m meta_interpolation_tpu_torch.main --model voxelflow \
        --mode val --dataset synthetic --loss 1*MSE --optimizer Adam \
        --metasgd --inner_lr 1e-5 --number_of_training_steps_per_iter 1 \
        --number_of_evaluation_steps_per_iter 1 --fast_warp_range 8 \
        [--enable_inner_loop_optimizable_bn_params] [--device cpu]
    python -m meta_interpolation_tpu_torch.main --model dain --mode val \
        --dataset synthetic --optimizer Adamax --metasgd --inner_lr 1e-5 \
        --loss 1*L1 --number_of_training_steps_per_iter 1 \
        --number_of_evaluation_steps_per_iter 1 --val_batch_size 1 \
        --pretrained_model dain_tamed.pth [--device cpu]

The scene-adaptation engine's flags go on any training or evaluation
line above: ``--attenuate`` (L2F), ``--per_step_bn_statistics``
(VoxelFlow) and a GAN term in ``--loss`` (``1*L1+0.005*GAN``, ``WGAN`` or
``WGAN_GP``; ``--disc_per_forward`` for the reference's cadence of
discriminator steps).

DAIN's random-init depth net overflows, so a random-weight run loads a
state dict whose depth head is tamed (``models/dain/model.
tame_depth_head_``); the meta system projects the flows exactly, as the
JAX package's does.

A CPU run of CAIN takes a tiny one: ``--depth 2 --n_resblocks 1
--crop_size 64``. ``--mode test`` renames the frames of ``--data_root`` to
``name_0.000000.<img_fmt>`` and writes each synthesized midpoint beside
them; a second run on the directory doubles the frame rate again. The
other readers: ``--dataset middlebury``, ``hd``, ``snufilm`` (with
``--test_mode``) and ``davis``.

Training writes ``checkpoint_dir/exp_name/checkpoint.pth`` every epoch
(and ``model_best.pth``); ``--resume`` continues from it. Runs on the CUDA
card unless ``--device cpu`` is given.

Episode (task) parallelism: start one rank a card with ``torchrun``,

    torchrun --standalone --nproc_per_node 4 -m \
        meta_interpolation_tpu_torch.main --model cain --mode train \
        --batch_size 8 [--mesh_shape 4] ...

Each rank runs its slice of every batch's tasks (here 2) on its own card
and the outer gradient is summed over the ranks (``parallel/mesh.py``);
only rank 0 writes. Ranks that share a card (more ranks than cards, or
``--device cpu``) talk over gloo, ranks on cards of their own over NCCL.
``--mesh_shape TxS`` adds a spatial axis: ranks along it hold the same
tasks. ``--episode_parallel false`` runs rank 0 alone. A plain ``python
-m`` run (or a world of one rank) starts no process group.

The exact row-sharded evaluation and meta-training split every frame's
rows over the ranks of the spatial axis (SepConv, CAIN, RRIN, SuperSloMo
and VoxelFlow, ``--mode val``, ``test`` and ``train``, first and second
order):

    torchrun --standalone --nproc_per_node 2 -m \
        meta_interpolation_tpu_torch.main --model sepconv --mode val \
        --dataset synthetic --loss 1*L1 --optimizer Adamax --metasgd \
        --inner_lr 1e-5 --number_of_evaluation_steps_per_iter 3 \
        --spatial_shards 2
    torchrun --standalone --nproc_per_node 2 -m \
        meta_interpolation_tpu_torch.main --model sepconv --mode train \
        --dataset synthetic --loss 1*L1 --optimizer Adamax --metasgd \
        --batch_size 3 --inner_lr 1e-5 --outer_lr 1e-5 \
        --number_of_training_steps_per_iter 3 \
        --number_of_evaluation_steps_per_iter 3 [--second_order] \
        --spatial_shards 2

``--spatial_shards S`` lays the ranks out 1xS (or TxS with
``--mesh_shape``, the batch split over the task axis; with
``--episode_parallel false`` the first S ranks run and the others idle).
In training the outer gradient is summed over every rank of the mesh
and rank 0 writes the checkpoint. ``--dtype bfloat16``, DAIN, the VGG,
SSIM and GAN terms, ``--attenuate``, ``--per_step_bn_statistics`` and
``--remat`` raise with ``--spatial_shards``.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from .config import Config, get_args
from .core.experiment import ExperimentBuilder
from .data.loader import MetaLearningSystemDataLoader
from .meta.system import SceneAdaptiveInterpolation
from .parallel import mesh as mesh_lib
from .parallel.mesh import log


def make_rank_mesh(cfg: Config, n_dev: int):
    """The mesh of a run of ``n_dev`` ranks (JAX main.py:22-55, the
    devices being ranks): None with one rank, or with
    ``--episode_parallel false`` and no ``--spatial_shards``. Returns
    (mesh, whether this rank takes part)."""
    if cfg.spatial_shards > 1 and n_dev == 1:
        # a sharding request that cannot be honored must not silently run
        # the full-frame unsharded graph (the OOM it was meant to avoid)
        raise ValueError(
            f"--spatial_shards {cfg.spatial_shards} requested but only one "
            f"device is visible; spatial sharding needs a multi-chip mesh")
    if n_dev == 1:
        return None, True
    if not (cfg.episode_parallel or cfg.spatial_shards > 1):
        return None, dist.get_rank() == 0
    shape, ranks = cfg.mesh_shape, None
    if cfg.spatial_shards > 1 and not shape:
        if not cfg.episode_parallel:
            # honor --episode_parallel false: spatial-only mesh on the
            # first spatial_shards ranks, the rest stay idle
            shape = f"1x{cfg.spatial_shards}"
            ranks = range(cfg.spatial_shards)
            log(f"[mesh] episode_parallel off: using "
                f"{cfg.spatial_shards}/{n_dev} devices spatially")
        else:
            if n_dev % cfg.spatial_shards:
                raise ValueError(
                    f"--spatial_shards {cfg.spatial_shards} must divide "
                    f"the device count ({n_dev})")
            shape = f"{n_dev // cfg.spatial_shards}x{cfg.spatial_shards}"
    mesh = mesh_lib.make_mesh(shape, ranks=ranks)
    if mesh is None:
        return None, False
    if cfg.spatial_shards > 1 and mesh.spatial == 1:
        raise ValueError(
            f"--spatial_shards {cfg.spatial_shards} but --mesh_shape "
            f"{shape} has a spatial axis of 1; use NxM with "
            f"M == spatial_shards")
    log(f"mesh: {mesh}")
    return mesh, True


def main(argv=None):
    cfg = get_args(argv)
    # a run of several ranks (torchrun) joins their process group here,
    # and leaves it at the end; a plain run starts none
    started = (int(os.environ.get("WORLD_SIZE", "1")) > 1
               and not dist.is_initialized())
    device = (mesh_lib.init_distributed(cfg.device)
              if dist.is_initialized() or started else None)
    try:
        n_dev = dist.get_world_size() if dist.is_initialized() else 1
        mesh, member = make_rank_mesh(cfg, n_dev)
        if not member:
            print(f"[mesh] rank {dist.get_rank()}: outside the mesh, idle")
            return None
        return _run(cfg, device, mesh)
    finally:
        if started:
            dist.destroy_process_group()


def _run(cfg: Config, device, mesh):
    system = SceneAdaptiveInterpolation(cfg, device=device, mesh=mesh)
    dev = system.device
    log(f"device: {dev}"
        + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda"
           else ""))
    if cfg.pretrained_model:
        from .core import checkpoint as ckpt_lib
        log(f"Loading pretrained model: {cfg.pretrained_model}")
        merged, loaded = ckpt_lib.import_pth(cfg.pretrained_model,
                                             system.model.state_dict())
        system.load_net(merged)
        log(f"[checkpoint] loaded {sum(loaded.values())}/{len(loaded)} "
            f"tensors")
        if cfg.fix_loaded:
            system.freeze_loaded(loaded)
            log("[fix_loaded] frozen the loaded parameters")
    # rank 0 first: a --mode test directory's frames are renamed when its
    # dataset is built
    if not mesh_lib.is_rank0():
        mesh_lib.barrier(mesh)
    data = MetaLearningSystemDataLoader(
        cfg, mesh_task_size=mesh.task if mesh is not None else 1)
    if mesh_lib.is_rank0():
        mesh_lib.barrier(mesh)
    return ExperimentBuilder(cfg, data, system).run_experiment()


if __name__ == "__main__":
    main()
