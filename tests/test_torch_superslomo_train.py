"""The port's SuperSloMo meta-training held against the JAX system on the
CPU: run_superslomo.sh (Adam, Meta-SGD, 1*Super with the JAX VGG16 weights
bridged, one inner step) in first order, with --fast_warp_range 4 and the
exact warp; second order at the inner SGD rule on the exact warp. Second
order on the bounded warp (K3-grad²'s path) is in
tests/test_torch_superslomo_train_second_order.py, a test process of its
own. The helpers, presets and limits are tests/test_torch_warp_train.py's.
"""
import pytest

from test_torch_warp_train import (  # noqa: F401 (two_threads)
    R, clips, config, counting_wrappers, hold_outer_to_jax, systems,
    train_launches, two_threads)
from meta_interpolation_tpu_torch.config import Config
from meta_interpolation_tpu_torch.meta.system import (
    SceneAdaptiveInterpolation)

pytestmark = pytest.mark.usefixtures("two_threads")


def hold_superslomo_to_jax(order, warp_range):
    jsys, tsys = systems(config("superslomo", order, warp_range))
    assert tsys.builder.returns_aux and tsys.loss_fn.vgg16_params is not None
    got = hold_outer_to_jax(jsys, tsys, clips("superslomo", 1))
    assert float(got["lrs"]["arbTimeFlowIntrp.conv3.weight"].norm()) > 0
    # the Super loss's VGG16 weights are the loss's, not meta-parameters
    assert not any(p.requires_grad for layer in
                   tsys.loss_fn.vgg16_params.values()
                   for p in layer.values())


@pytest.mark.parametrize("order,warp_range", [
    ("first", R), ("first", 0), ("second", 0)])
def test_superslomo_outer_loss_and_gradient_match_jax(order, warp_range):
    hold_superslomo_to_jax(order, warp_range)


@pytest.mark.parametrize("order", ["first", "second"])
def test_train_iteration_calls_each_wrapper_as_derived(order, monkeypatch):
    """Six warps a forward, one inner step: 18 K3 and 18 K3-grad a task in
    first order; 18, 30 and 12 K3-grad² in second order (the outer
    backward runs each support warp's K3 node and its K3-grad node)."""
    counts = counting_wrappers(monkeypatch)
    system = SceneAdaptiveInterpolation(Config(
        **config("superslomo", order, R), device="cpu"))
    system.run_train_iter(clips("superslomo", 1), 0)
    assert counts == train_launches(1, 6, order == "second")
