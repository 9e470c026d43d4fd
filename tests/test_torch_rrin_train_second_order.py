"""The port's RRIN second-order meta-training on the bounded warp
(--fast_warp_range 4: K3, K3-grad and K3-grad²'s plain versions on the
CPU) held against the JAX system: one inner SGD step, batch 1. Its own
test process: the JAX second order through the unrolled sweep at RRIN's
128x128 padded frame takes most of a minute. The first-order and
exact-warp cases are in tests/test_torch_rrin_train.py.
"""
import pytest

from test_torch_rrin_train import hold_rrin_to_jax
from test_torch_warp_train import R, two_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("two_threads")


@pytest.mark.parametrize("order,warp_range", [("second", R)])
def test_rrin_outer_loss_and_gradient_match_jax(order, warp_range):
    hold_rrin_to_jax(order, warp_range)
