"""VoxelFlow under --dtype bfloat16 held on the CPU against the JAX package
(run_voxelflow.sh: Adam, Meta-SGD, 1*MSE, one inner step; JAX op by op,
its forwards through ``bf16_apply``, its bounded sweep on the TPU kernel's
function as tests/test_torch_bf16_models.py routes it):

  * the scene-adaptive evaluation episode on the exact warp (both sides
    sample with one bilinear gather at float32 coordinates), and on the
    bounded warp (R = 4);
  * --per_step_bn_statistics: one first-order training iteration, the
    statistics it writes back (float32, from the bf16 forwards' batch
    statistics) and the outer loss and gradient. With the per-step
    affine rows in float32, JAX's batch norm leaves the layer in float32
    (``models/layers.py:599``), so the rest of its network runs in float32
    and so does the port's (``layers.meta_batch_norm``,
    ``layers.conv_as_input``).

Rule, bf16 itself: |port − JAX bf16| ≤ 2·|JAX bf16 − JAX float32| +
1e-5·max|JAX bf16| in max norm, on the prediction, the loss, the
statistics (all BN tensors together) and each group's outer gradient.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meta_interpolation_tpu.config import Config as JaxConfig
from meta_interpolation_tpu.meta.system import (
    SceneAdaptiveInterpolation as JaxSystem)
from meta_interpolation_tpu_torch.config import Config
from meta_interpolation_tpu_torch.core import checkpoint as bridge
from meta_interpolation_tpu_torch.meta.system import (
    SceneAdaptiveInterpolation)
from test_torch_bf16_models import (  # noqa: F401 (fixtures)
    hold, tpu_kernels, one_thread)
from test_torch_per_step_bn import PRESET, bn_from_jax, clips
from test_torch_warp_models_episode import PRESETS

pytestmark = pytest.mark.usefixtures("one_thread", "tpu_kernels")


def _cat(tree, keys):
    return np.concatenate([np.asarray(tree[k], np.float32).ravel()
                           for k in keys])


@pytest.mark.parametrize("warp_range", [0, 4])
def test_voxelflow_bf16_episode_matches_jax(warp_range):
    cfg = dict(PRESETS["voxelflow"], fast_warp_range=warp_range,
               crop_size=32)
    frames = clips(1, "val", crop=32)
    want = {}
    for dtype in ("float32", "bfloat16"):
        jsys = JaxSystem(JaxConfig(**cfg, dtype=dtype, jit_episode=False))
        losses, preds = jsys.run_validation_iter(frames)
        want[dtype] = (np.float32(losses["loss"]),
                       np.asarray(preds, np.float32))
    tsys = SceneAdaptiveInterpolation(Config(**cfg, device="cpu",
                                             dtype="bfloat16"))
    tsys.load_net(bridge.params_from_jax(
        jax.tree.map(np.asarray, jsys.meta_params["net"]), tsys.model))
    losses, preds = tsys.run_validation_iter(frames)
    assert preds.dtype == torch.float32
    hold(preds.numpy().transpose(0, 2, 3, 1), want["bfloat16"][1],
         want["float32"][1], "prediction")
    hold(np.float32(losses["loss"]), want["bfloat16"][0],
         want["float32"][0], "loss")


def test_voxelflow_bf16_per_step_bn_iteration_matches_jax():
    cfg = dict(PRESET, batch_size=1)
    frames = clips(1)
    want = {}
    for dtype in ("float32", "bfloat16"):
        jsys = JaxSystem(JaxConfig(**cfg, dtype=dtype, jit_episode=False))
        spec = jsys._episode_spec("train", 1, False, False)

        def outer(mp):
            out = jsys.builder.task_episode(mp, jnp.asarray(frames[0]),
                                            jnp.ones((1,)), spec,
                                            training=True)
            return out[0], out[-1]

        (loss, bn), grads = jax.value_and_grad(outer, has_aux=True)(
            jsys.meta_params)
        want[dtype] = (np.float32(loss), bn_from_jax(bn),
                       jax.tree.map(np.asarray, grads))
    tsys = SceneAdaptiveInterpolation(Config(**cfg, device="cpu",
                                             dtype="bfloat16"))
    bridge.load_jax_meta_params(tsys, jax.tree.map(np.asarray,
                                                   jsys.meta_params))
    loss, aux, got = tsys.outer_grads(frames, 0)
    hold(np.float32(float(loss)), want["bfloat16"][0], want["float32"][0],
         "outer loss")
    stats = sorted(aux["bn_state"])
    assert all(aux["bn_state"][k].dtype == torch.float32 for k in stats)
    hold(_cat({k: v.numpy() for k, v in aux["bn_state"].items()}, stats),
         _cat(want["bfloat16"][1], stats), _cat(want["float32"][1], stats),
         "per-step BN statistics")
    for group in ("net", "lrs"):
        ref = {d: bridge.params_from_jax(want[d][2][group], tsys.model)
               for d in want}
        by_module = {}
        for name in tsys.meta_params[group]:
            by_module.setdefault(name.split(".")[0], []).append(name)
        for module, names in by_module.items():
            hold(_cat({k: got[group][k].numpy() for k in names}, names),
                 _cat(ref["bfloat16"], names), _cat(ref["float32"], names),
                 f"{group} gradient of {module}")
