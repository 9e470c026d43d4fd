"""Legacy DAIN trainer (reference ``legacy/train_dain.py``).

The reference's defaults (:114, :210, :225): Adamax over rectifyNet ONLY,
in both the inner and the outer optimizer, and the charbonnier pixel loss.
Every other subnet stays frozen: both loops take DAIN's inner mask. The
forward is DAIN's default, as JAX ``dain.apply``'s: the exact projection
and no hole filling.

    python -m meta_interpolation_tpu_torch.legacy.train_dain \
        --meta_algorithm maml --batch_size 1 --crop_size 192
"""
from .driver import LegacyPreset, run

PRESET = LegacyPreset(model="dain", inner_rule="Adamax",
                      outer_opt="Adamax", loss_spec="charbonnier",
                      inner_lr=1e-5, outer_lr=5e-5,
                      mask_rectify_only=True)


def main(argv=None):
    return run(PRESET, argv)


if __name__ == "__main__":
    main()
