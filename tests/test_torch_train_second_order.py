"""Second-order meta-training of SepConv held against the JAX package on
the CPU: the outer gradient through one inner step, taken through the
port's twice-differentiable sepconv, against ``jax.grad`` of the JAX
episode with ``second_order=True`` (which differentiates the plain jnp op).

A file of its own so that its JAX compile runs beside the first-order
one (``--dist loadfile``). One JAX system and one port system, the JAX
init bridged into the port: crop 32, batch 1, 1 inner step, Adamax,
Meta-SGD.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meta_interpolation_tpu.config import Config as JaxConfig
from meta_interpolation_tpu.meta import episode as jax_episode
from meta_interpolation_tpu.meta import system as jax_system
from meta_interpolation_tpu_torch.config import Config
from meta_interpolation_tpu_torch.core import checkpoint as bridge
from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
from meta_interpolation_tpu_torch.meta import system

CFG = dict(model="sepconv", optimizer="Adamax", metasgd=True, inner_lr=1e-5,
           outer_lr=1e-5, crop_size=32, batch_size=1, mode="train",
           number_of_training_steps_per_iter=1, second_order=True,
           loss="1*L1")
# per-leaf ‖g_port − g_jax‖ ≤ GRAD_RTOL·‖g_jax‖ + GRAD_ATOL, as the
# first-order file: float32 in another summation order, and an inner
# Adamax step of ~lr·sign(g) that may flip where g is within rounding of 0
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's PyTorch work: the tier-1 run
    puts six test processes on the machine's cores, where every process
    taking a thread a core oversubscribes them many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def systems():
    jsys = jax_system.SceneAdaptiveInterpolation(JaxConfig(**CFG))
    tsys = system.SceneAdaptiveInterpolation(Config(**CFG, device="cpu"))
    np_tree = jax.tree.map(np.asarray, jsys.meta_params)
    with torch.no_grad():
        for g in ("net", "lrs"):
            for name, value in bridge.params_from_jax(np_tree[g],
                                                      tsys.model).items():
                tsys.meta_params[g][name].copy_(value)
    frames = np.asarray(SyntheticSeptuplet(model="sepconv", mode="train",
                                           size=(32, 32))[0][0])[None]
    return jsys, tsys, frames


def test_second_order_outer_gradient_matches_jax(systems):
    jsys, tsys, frames = systems
    assert jsys._use_second_order(0) and tsys._use_second_order(0)
    spec = jsys._episode_spec("train", 1, True, False)
    msl_w = jnp.asarray(jax_episode.per_step_loss_importance(1, 0, 1))

    def outer(mp):
        # the one task's episode: what the batched episode vmaps (the
        # vmapped program takes ~2x as long to trace and compile on an
        # 8-core CPU)
        return jsys.builder.task_episode(mp, jnp.asarray(frames[0]), msl_w,
                                         spec, training=True)[0]

    want_loss, want = jax.jit(jax.value_and_grad(outer))(jsys.meta_params)
    loss, _, got = tsys.outer_grads(frames, 0)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    np_want = jax.tree.map(np.asarray, want)
    for group in ("net", "lrs"):
        for name, w in bridge.params_from_jax(np_want[group],
                                              tsys.model).items():
            err, ref = float((got[group][name] - w).norm()), float(w.norm())
            assert err <= GRAD_RTOL * ref + GRAD_ATOL, (group, name, err,
                                                         ref)

    # the kernel subnets are inner-frozen: only second order carries the
    # cross term d(inner grad)/d(subnet) into their outer gradient
    first = system.SceneAdaptiveInterpolation(
        Config(**dict(CFG, second_order=False), device="cpu"))
    first.load_state_dict(tsys.state_dict())
    _, _, first_grads = first.outer_grads(frames, 0)
    for name in ("moduleVertical1.0.weight", "moduleHorizontal2.7.weight"):
        second, once = got["net"][name], first_grads["net"][name]
        assert float((second - once).norm()) > 1e-3 * float(once.norm()), (
            name)
