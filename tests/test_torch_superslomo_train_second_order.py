"""The port's SuperSloMo second-order meta-training on the bounded warp
(--fast_warp_range 4: six warps a forward through K3, K3-grad and
K3-grad²'s plain versions, the Super loss's double backward through its
VGG16) held against the JAX system: one inner SGD step, batch 1. Its own
test process: the JAX second order through the unrolled sweep takes most
of two minutes op by op, a third less with the sweep compiled on its own
(tests/test_torch_warp_train.py ``jitted_sweep``). The other cases are in
tests/test_torch_superslomo_train.py.
"""
import pytest

from test_torch_superslomo_train import hold_superslomo_to_jax
from test_torch_warp_train import R, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("order,warp_range", [("second", R)])
def test_superslomo_outer_loss_and_gradient_match_jax(order, warp_range):
    hold_superslomo_to_jax(order, warp_range)
