"""Legacy SuperSloMo trainer (reference ``legacy/train_superslomo.py``).

The reference's defaults (:113-119, :288): Adam inner and outer
optimizers and the SuperSloMo composite loss (``1*Super``: 204·recn +
102·warp + 0.005·perceptual + smoothness). The perceptual term needs
torchvision VGG16 weights; without them the loss warns and runs on a He
init.

    python -m meta_interpolation_tpu_torch.legacy.train_superslomo \
        --meta_algorithm maml --batch_size 2
"""
from .driver import LegacyPreset, run

PRESET = LegacyPreset(model="superslomo", inner_rule="Adam",
                      outer_opt="Adam", loss_spec="1*Super",
                      inner_lr=1e-5, outer_lr=1e-4)


def main(argv=None):
    return run(PRESET, argv)


if __name__ == "__main__":
    main()
