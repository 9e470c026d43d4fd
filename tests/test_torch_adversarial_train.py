"""Meta-training with an adversarial term held against the JAX package on
the CPU: a training iteration of each GAN type in both cadences on
VoxelFlow (the fast op-by-op JAX episode, on the exact warp), and the
outer gradient with a generator term in float64. A file of its own beside
tests/test_torch_adversarial.py (whose helpers and limits it takes), so
the two run side by side under ``--dist loadfile``.

The outer gradient with a generator term is held in float64, both sides'
training episodes, each tensor within 1e-4 of its norm (measured: 5.4e-6
for the net and 2.0e-5 for the Meta-SGD rates, per group). In float32 it
is ill-conditioned: each side's alone is 1.4e-3 (net) and 1.1e-3 to 3.0e-3
(rates) of its norm from its own float64 value at batch 2 on the bounded
warp, and two float32 evaluations differ by up to 4e-2 (rates) on the exact
warp, so it cannot be held to the 1e-3 of the other files there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meta_interpolation_tpu.config import Config as JaxConfig
from meta_interpolation_tpu.core import adversarial as jadv
from meta_interpolation_tpu.meta.system import (
    SceneAdaptiveInterpolation as JaxSystem)
from meta_interpolation_tpu_torch.config import Config
from meta_interpolation_tpu_torch.core import checkpoint as bridge
from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
from meta_interpolation_tpu_torch.meta.system import (
    SceneAdaptiveInterpolation)
from test_torch_adversarial import CROP, TYPES, hold_steps, jax_eps, nhwc

GRAD64_RTOL = 1e-4
VF = dict(model="voxelflow", optimizer="SGD", metasgd=True, inner_lr=1e-3,
          outer_lr=1e-3, number_of_training_steps_per_iter=1,
          number_of_evaluation_steps_per_iter=1, crop_size=CROP,
          mode="train", fast_warp_range=0, batch_size=2)

pytestmark = pytest.mark.usefixtures("two_threads")


@pytest.fixture(scope="module")
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def clips(n):
    data = SyntheticSeptuplet(model="voxelflow", mode="train",
                              size=(CROP, CROP))
    return np.stack([np.asarray(data[i][0]) for i in range(n)])


def jax_iteration_eps(jsys, epoch, n, replay):
    """The WGAN-GP weights JAX's run_train_iter draws on its first call."""
    rng = jax.random.fold_in(jax.random.PRNGKey(epoch * 100003 + 17), 1)
    if replay:
        return np.concatenate([jax_eps(k, 1)
                               for k in jax.random.split(rng, n)])
    return jax_eps(jax.random.split(rng)[1], n)


@pytest.mark.parametrize("gan_type", TYPES)
@pytest.mark.parametrize("cadence", ["batched", "per_forward"])
def test_train_iteration_matches_jax(gan_type, cadence, monkeypatch):
    """run_train_iter on VoxelFlow with a GAN term: its predictions, and
    the discriminator after its update(s):
    one on the B query predictions, or the B·(S·P + Sq + 1) single-item
    replay (2 inner steps with MSL: 2·(2·2 + 1 + 1) = 12), whose inputs
    are held to those JAX builds from its own episode. The outer gradient
    the iteration takes is held in float64 below."""
    per_forward = cadence == "per_forward"
    cfg = dict(VF, loss=f"1*MSE+0.005*{gan_type}",
               disc_per_forward=per_forward)
    if per_forward:
        cfg.update(number_of_training_steps_per_iter=2,
                   use_multi_step_loss_optimization=True)
    jsys = JaxSystem(JaxConfig(**cfg, jit_episode=False))
    tsys = SceneAdaptiveInterpolation(Config(**cfg, device="cpu"))
    bridge.load_jax_meta_params(tsys, jax.tree.map(np.asarray,
                                                   jsys.meta_params))
    n = 12 if per_forward else 2
    eps = torch.from_numpy(jax_iteration_eps(jsys, 0, n, per_forward))
    if gan_type == "WGAN_GP":
        tsys.adv_state.draw_eps = lambda count, generator=None: (
            eps if count == n else pytest.fail(f"{count} weights drawn"))
    # each side's replay inputs, as built from its own episode
    replays = {"jax": [], "port": []}
    real_replay = tsys.adv_state.replay
    tsys.adv_state.replay = lambda f, r, *a, **k: replays["port"].append(
        (f, r)) or real_replay(f, r, *a, **k)
    real_sequence = jadv.build_replay_sequence
    monkeypatch.setattr(jadv, "build_replay_sequence", lambda *a: replays[
        "jax"].append(real_sequence(*a)) or replays["jax"][-1])
    frames = clips(2)
    _, want_preds = jsys.run_train_iter(frames, 0)
    _, preds = tsys.run_train_iter(frames, 0)
    np.testing.assert_allclose(nhwc(preds), np.asarray(want_preds),
                               atol=1e-5)
    assert len(replays["port"]) == len(replays["jax"]) == int(per_forward)
    for (f, r), (jf, jr) in zip(replays["port"], replays["jax"]):
        assert f.shape == (n, 1, 3, CROP, CROP)
        np.testing.assert_allclose(nhwc(f[:, 0]), np.asarray(jf[:, 0]),
                                   atol=1e-6)
        np.testing.assert_array_equal(nhwc(r[:, 0]), np.asarray(jr[:, 0]))
    want = jax.tree.map(np.asarray, jsys.meta_params)
    hold_steps(tsys.meta_params["loss_ctx"],
               bridge.disc_params_from_jax(want["loss_ctx"]["disc"]),
               tsys.adv_state.opt.param_groups[0]["lr"], cadence,
               steps=n if per_forward else 1)


@pytest.mark.parametrize("gan_type", ["GAN", "WGAN"])
def test_outer_gradient_with_a_gan_term_matches_jax_in_float64(gan_type):
    """A training episode in float64 on both sides (JAX with x64 on, op by
    op), at the inner SGD rule: every tensor's outer gradient, the
    discriminator's parameters handed in as the loss's ctx (WGAN-GP's
    generator term is WGAN's)."""
    cfg = dict(VF, loss=f"1*MSE+0.005*{gan_type}", batch_size=1)
    jsys = JaxSystem(JaxConfig(**cfg, jit_episode=False))
    tsys = SceneAdaptiveInterpolation(Config(**cfg, device="cpu"))
    bridge.load_jax_meta_params(tsys, jax.tree.map(np.asarray,
                                                   jsys.meta_params))
    frames = clips(1)
    spec = jsys._episode_spec("train", 1, False, False)
    jax.config.update("jax_enable_x64", True)
    try:
        mp = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64),
                          jsys.meta_params)
        grads = jax.grad(lambda m: sum(
            jsys.builder.task_episode(m, jnp.asarray(f, jnp.float64),
                                      jnp.ones(1), spec, training=True)[0]
            for f in frames) / len(frames))(mp)
        want = jax.tree.map(np.asarray, grads)
    finally:
        jax.config.update("jax_enable_x64", False)
    leaves = {g: {k: v.detach().double().requires_grad_(
                  tsys.trainable[g][k]) for k, v in tree.items()}
              for g, tree in tsys.meta_params.items()}
    tsys.model.double()
    tsys.builder.batched_episode(
        leaves, tsys._frames(frames).double(), np.ones(1),
        tsys._spec("train", 1), training=True)
    for g in ("net", "lrs"):
        ref = bridge.params_from_jax(want[g], tsys.model)
        for name, leaf in leaves[g].items():
            got = leaf.grad if leaf.grad is not None else torch.zeros_like(
                leaf)
            err = float((got - ref[name]).norm())
            assert err <= GRAD64_RTOL * float(ref[name].norm()) + 1e-30, (
                g, name, err, float(ref[name].norm()))
        assert float(leaves[g]["conv1.weight"].grad.norm()) > 0, g
