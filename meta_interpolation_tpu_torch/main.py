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
"""
from __future__ import annotations

import torch

from .config import get_args
from .core.experiment import ExperimentBuilder
from .data.loader import MetaLearningSystemDataLoader
from .meta.system import SceneAdaptiveInterpolation


def main(argv=None):
    cfg = get_args(argv)
    system = SceneAdaptiveInterpolation(cfg)
    dev = system.device
    print(f"device: {dev}"
          + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda"
             else ""))
    if cfg.pretrained_model:
        from .core import checkpoint as ckpt_lib
        print(f"Loading pretrained model: {cfg.pretrained_model}")
        merged, loaded = ckpt_lib.import_pth(cfg.pretrained_model,
                                             system.model.state_dict())
        system.load_net(merged)
        print(f"[checkpoint] loaded {sum(loaded.values())}/{len(loaded)} "
              f"tensors")
        if cfg.fix_loaded:
            system.freeze_loaded(loaded)
            print("[fix_loaded] frozen the loaded parameters")
    data = MetaLearningSystemDataLoader(cfg)
    return ExperimentBuilder(cfg, data, system).run_experiment()


if __name__ == "__main__":
    main()
