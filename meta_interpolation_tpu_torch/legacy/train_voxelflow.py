"""Legacy VoxelFlow trainer (reference ``legacy/train_voxelflow.py``).

The reference's defaults (:107-108, :166): MSE, Adam inner and outer
optimizers; the loop of train_sepconv (:160-206).

    python -m meta_interpolation_tpu_torch.legacy.train_voxelflow \
        --meta_algorithm maml --batch_size 4
"""
from .driver import LegacyPreset, run

PRESET = LegacyPreset(model="voxelflow", inner_rule="Adam",
                      outer_opt="Adam", loss_spec="1*MSE")


def main(argv=None):
    return run(PRESET, argv)


if __name__ == "__main__":
    main()
