"""A SepConv meta-training iteration of the port under the SSIM and VGG19
terms (``--loss 1*L1+0.1*VGG22+1*SSIM``), held against the JAX package's
on the CPU: the first-order outer loss and gradient with Meta-SGD.

One task at crop 32 (padded to 128×128 by the model), 1 inner step,
Adamax; the JAX task episode is jitted, as tests/test_torch_train.py runs
it. The loss's VGG19 weights are the JAX system's own random init (no
pretrained file on the search path), bridged into the port.
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

LOSS = "1*L1+0.1*VGG22+1*SSIM"
CFG = dict(model="sepconv", optimizer="Adamax", metasgd=True, inner_lr=1e-5,
           outer_lr=1e-5, crop_size=32, batch_size=1, mode="train",
           number_of_training_steps_per_iter=1, loss=LOSS)
# the loss to 1e-5, each parameter group's gradient to 1e-3 of its norm,
# the limits of the chip's card-vs-CPU train checks: an inner Adamax step
# is ~lr·sign(g), so an element whose support gradient is within rounding
# of zero steps the other way and moves its Meta-SGD rate's gradient (one
# tensor's share of such elements is larger than its group's)
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _closure(fn, name):
    return fn.__closure__[fn.__code__.co_freevars.index(name)].cell_contents


@pytest.fixture(scope="module")
def systems(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    # an empty weights search path on both sides: the random inits
    mp.setenv("HOME", str(tmp_path_factory.mktemp("home")))
    mp.chdir(tmp_path_factory.mktemp("cwd"))
    mp.delenv("MIT_VGG_WEIGHTS", raising=False)
    try:
        jsys = jax_system.SceneAdaptiveInterpolation(JaxConfig(**CFG))
        tsys = system.SceneAdaptiveInterpolation(Config(**CFG, device="cpu"))
    finally:
        mp.undo()
    np_tree = jax.tree.map(np.asarray, jsys.meta_params)
    with torch.no_grad():
        for group in ("net", "lrs"):
            for name, value in bridge.params_from_jax(
                    np_tree[group], tsys.model).items():
                tsys.meta_params[group][name].copy_(value)
    vgg19 = jax.tree.map(np.asarray, _closure(jsys.loss_fn, "vgg19_params"))
    assert sorted(vgg19) == [f"conv_{i}" for i in range(4)]   # cut 8
    tsys.loss_fn.vgg19_params = bridge.vgg19_params_from_jax(vgg19)
    frames = np.asarray(SyntheticSeptuplet(model="sepconv", mode="train",
                                           size=(32, 32))[0][0])[None]
    return jsys, tsys, frames


def test_first_order_outer_gradient_matches_jax(systems):
    jsys, tsys, frames = systems
    spec = jsys._episode_spec("train", 1, False, False)
    msl_w = jnp.asarray(jax_episode.per_step_loss_importance(1, 0, 1))

    def outer(mp, task):
        o, _, q = jsys.builder.task_episode(mp, task, msl_w, spec,
                                            training=True)
        return o, q

    (want_loss, _), grads = jax.jit(jax.value_and_grad(
        outer, has_aux=True))(jsys.meta_params, jnp.asarray(frames[0]))
    grads = jax.tree.map(lambda g, m: np.asarray(g) * float(m), grads,
                         jsys._trainable_mask)
    loss, aux, got = tsys.outer_grads(frames, 0)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_RTOL)
    for group in ("net", "lrs"):
        want = bridge.params_from_jax(grads[group], tsys.model)
        err = sum(float((got[group][k] - w).norm()) ** 2
                  for k, w in want.items()) ** 0.5
        ref = sum(float(w.norm()) ** 2 for w in want.values()) ** 0.5
        assert err <= GRAD_RTOL * ref, (group, err, ref)
    assert float(got["lrs"]["moduleConv1.0.weight"].norm()) > 0
    # every term contributes
    terms = tsys.loss_fn(aux["preds"], torch.as_tensor(
        frames[:, 3].transpose(0, 3, 1, 2)))
    assert set(terms) == {"L1", "VGG22", "SSIM", "total"}
    assert all(float(v) > 0 for v in terms.values())
