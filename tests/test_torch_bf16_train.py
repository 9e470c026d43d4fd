"""SepConv's first-order meta-training iteration under --dtype bfloat16
held on the CPU against the JAX package's (run_sepconv.sh's rule: Adamax,
Meta-SGD, MSL; one task of one inner step at crop 32, as
tests/test_torch_train.py holds the float32 one): the outer loss and the
outer gradient of every meta-parameter group, the port's from
``outer_grads``, JAX's from jax.value_and_grad of its training task
episode, whose forwards run through ``bf16_apply`` (the sepconv op on its
TPU kernel's function, as tests/test_torch_bf16_models.py routes it).

Rule, bf16 itself: |port − JAX bf16| ≤ 2·|JAX bf16 − JAX float32| +
1e-5·max|JAX bf16| in max norm, on the loss and on each group's gradient
(the net's parameters under one top-level module, and the Meta-SGD rates
likewise).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from meta_interpolation_tpu.config import Config as JaxConfig
from meta_interpolation_tpu.meta import episode as jax_episode
from meta_interpolation_tpu.meta import system as jax_system
from meta_interpolation_tpu_torch.config import Config
from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
from meta_interpolation_tpu_torch.meta import system
from test_torch_bf16_models import (  # noqa: F401 (fixtures)
    hold, tpu_kernels, one_thread)
from test_torch_train import _bridge_meta, _jax_grads_as_port

CFG = dict(model="sepconv", optimizer="Adamax", metasgd=True, inner_lr=1e-5,
           outer_lr=1e-5, crop_size=32, batch_size=1, mode="train",
           number_of_training_steps_per_iter=1,
           use_multi_step_loss_optimization=True, loss="1*L1")

pytestmark = pytest.mark.usefixtures("one_thread", "tpu_kernels")


def jax_outer(jsys, task):
    """JAX's outer loss and masked gradient of one training task."""
    spec = jsys._episode_spec("train", 1, False, jsys._msl_active(0))
    msl_w = jnp.asarray(jax_episode.per_step_loss_importance(1, 0, 1))

    def outer(mp):
        return jsys.builder.task_episode(mp, jnp.asarray(task), msl_w, spec,
                                         training=True)[0]

    loss, grads = jax.jit(jax.value_and_grad(outer))(jsys.meta_params)
    grads = jax.tree.map(lambda g, m: g * float(m), grads,
                         jsys._trainable_mask)
    return float(loss), grads


def test_sepconv_bf16_outer_gradient_matches_jax():
    data = SyntheticSeptuplet(model="sepconv", mode="train", size=(32, 32))
    frames = np.asarray(data[0][0])[None]
    want = {}
    for dtype in ("float32", "bfloat16"):
        jsys = jax_system.SceneAdaptiveInterpolation(
            JaxConfig(**CFG, dtype=dtype))
        want[dtype] = jax_outer(jsys, frames[0])
    tsys = system.SceneAdaptiveInterpolation(
        Config(**CFG, device="cpu", dtype="bfloat16"))
    _bridge_meta(jsys, tsys)
    loss, aux, got = tsys.outer_grads(frames, 0)
    hold(np.float32(float(loss)), np.float32(want["bfloat16"][0]),
         np.float32(want["float32"][0]), "outer loss")
    ref = {d: _jax_grads_as_port(want[d][1], tsys) for d in want}
    for group in ("net", "lrs"):
        by_module = {}
        for name in tsys.meta_params[group]:
            by_module.setdefault(name.split(".")[0], []).append(name)
        for module, names in by_module.items():
            cat = lambda src: np.concatenate(
                [np.asarray(src[k], np.float32).ravel() for k in names])
            hold(cat({k: got[group][k].numpy() for k in names}),
                 cat(ref["bfloat16"][group]), cat(ref["float32"][group]),
                 f"{group} gradient of {module}")
            assert all(got[group][k].dtype == tsys.meta_params[group][k].dtype
                       for k in names)
    assert float(np.abs(got["lrs"]["moduleConv1.0.weight"].numpy()).max()) > 0
