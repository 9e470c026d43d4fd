"""Legacy SepConv trainer (reference ``legacy/train_sepconv.py``).

The reference's defaults (:65-71): L1, Adamax inner and outer optimizers,
crop 128, Reptile or first-order MAML.

    python -m meta_interpolation_tpu_torch.legacy.train_sepconv \
        --meta_algorithm maml --batch_size 4 --inner_lr 1e-5 --outer_lr 1e-5
"""
from .driver import LegacyPreset, run

PRESET = LegacyPreset(model="sepconv", inner_rule="Adamax",
                      outer_opt="Adamax", loss_spec="1*L1")


def main(argv=None):
    return run(PRESET, argv)


if __name__ == "__main__":
    main()
