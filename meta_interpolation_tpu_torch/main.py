"""CLI entry point.

    python -m meta_interpolation_tpu_torch.main --model sepconv --mode val \
        --dataset synthetic --optimizer Adamax --metasgd --inner_lr 1e-5 \
        --number_of_evaluation_steps_per_iter 3 --val_batch_size 1 \
        --loss 1*L1 [--device cpu]

Runs on the CUDA card unless ``--device cpu`` is given.
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
    data = MetaLearningSystemDataLoader(cfg)
    return ExperimentBuilder(cfg, data, system).run_experiment()


if __name__ == "__main__":
    main()
