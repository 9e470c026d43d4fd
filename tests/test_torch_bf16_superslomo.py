"""SuperSloMo under --dtype bfloat16, held on the CPU against the JAX
package's jitted apply through its own ``bf16_apply``, as
tests/test_torch_bf16_models.py holds the other models (its helpers, its
JAX ops on their TPU kernels' function, its rule: |port − JAX bf16| ≤
2·|JAX bf16 − JAX float32| + 1e-5·max|JAX bf16| in max norm): the
prediction on the exact and the bounded warp, and the gradient of every
parameter group on the bounded one.
"""
import jax
import numpy as np
import pytest

from meta_interpolation_tpu.models import registry as jax_registry
from meta_interpolation_tpu_torch.models import superslomo
from test_torch_bf16_models import (  # noqa: F401 (fixtures)
    check_forward, check_vjp, frames, port_model, tpu_kernels, one_thread)

pytestmark = pytest.mark.usefixtures("one_thread", "tpu_kernels")


@pytest.mark.parametrize("warp_range", [None, 4])
def test_superslomo_bf16_forward_and_vjp(warp_range):
    params = jax.tree.map(np.asarray, jax_registry.get("superslomo").init(
        jax.random.PRNGKey(0)))
    model = port_model(superslomo.SuperSloMo, params, warp_range=warp_range)
    f0, f1 = frames(seed=4)
    kw = {"warp_range": warp_range} if warp_range else {}
    check_forward("superslomo", model, params, f0, f1, kw)
    if warp_range:
        check_vjp("superslomo", model, params, f0, f1, kw)
