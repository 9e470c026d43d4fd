"""The port's RRIN meta-training held against the JAX system on the CPU:
run_rrin.sh (Adam, LSLR with fixed rates, 1*L1, no inner step: a plain
fine-tune) in first order with --fast_warp_range 4 and the exact warp, and
one inner SGD step in second order on the exact warp, and the training
CLI; second order on the bounded warp (K3-grad²'s path) is in
tests/test_torch_rrin_train_second_order.py, a test process of its own.
The helpers, presets and limits are tests/test_torch_warp_train.py's.
"""
import pytest
import torch

from test_torch_warp_models_episode import train_cli_on_the_cpu
from test_torch_warp_train import (  # noqa: F401 (one_thread)
    R, clips, config, hold_outer_to_jax, systems, one_thread)
from meta_interpolation_tpu_torch.meta import episode

pytestmark = pytest.mark.usefixtures("one_thread")


MASK_WEIGHT = "Mask.down_path.0.block.0.weight"


def hold_rrin_to_jax(order, warp_range):
    jsys, tsys = systems(config("rrin", order, warp_range))
    got = hold_outer_to_jax(jsys, tsys, clips("rrin", 1))
    assert float(got["net"][MASK_WEIGHT].norm()) > 0


@pytest.mark.parametrize("order,warp_range", [
    ("first", R), ("first", 0), ("second", 0)])
def test_rrin_outer_loss_and_gradient_match_jax(order, warp_range):
    hold_rrin_to_jax(order, warp_range)


def test_mask_unet_trains_outer_but_never_adapts():
    """The Mask U-Net is inner-frozen (the reference forward calls it
    without the adapted weights) and outer-trainable: an inner step leaves
    it as it was, and the outer gradient reaches it in both orders."""
    cfg = config("rrin", "second", R)
    _, tsys = systems(cfg)
    frames = tsys._frames(clips("rrin", 1))[0]
    spec = episode.EpisodeSpec(support_idxs=tsys.cfg.support_idxs("train"),
                               num_steps=1)
    net = tsys.meta_params["net"]
    adapted = tsys.builder.adapt(net, tsys.meta_params["lrs"], frames, spec)
    moved = {name: not torch.equal(adapted[name], value)
             for name, value in net.items()}
    mask = [k for k in moved if k.startswith("Mask.")]
    others = [k for k in moved if not k.startswith("Mask.")]
    assert mask and not any(moved[k] for k in mask)
    assert sum(moved[k] for k in others) >= 0.9 * len(others)
    assert all(tsys.trainable["net"].values())


@pytest.mark.parametrize("order", ["first", "second"])
def test_cli_trains_rrin_on_the_cpu(order, tmp_path, capsys):
    train_cli_on_the_cpu("rrin", order, tmp_path, capsys)
