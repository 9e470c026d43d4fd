"""SepConv's scene-adaptive evaluation under --dtype bfloat16 held on the
CPU against the JAX package's (its episode runs every forward through
``bf16_apply``; the sepconv op on its TPU kernel's function, as
tests/test_torch_bf16_models.py routes it), and the bf16 system's own
contract: float32 meta-parameters, rates and optimizer state, float32
predictions.

Rule, bf16 itself: |port − JAX bf16| ≤ 2·|JAX bf16 − JAX float32| +
1e-5·max|JAX bf16| in max norm, on the prediction and on the loss. At
random init SepConv's prediction is near zero and its PSNR does not move
with bf16 (the rounding is below an 8-bit level), so the PSNR is only
reported.
"""
import jax
import numpy as np
import pytest
import torch

from meta_interpolation_tpu.config import Config as JaxConfig
from meta_interpolation_tpu.meta.system import (
    SceneAdaptiveInterpolation as JaxSystem)
from meta_interpolation_tpu_torch.config import Config
from meta_interpolation_tpu_torch.core import checkpoint as bridge
from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
from meta_interpolation_tpu_torch.meta.system import (
    SceneAdaptiveInterpolation)
from test_torch_bf16_models import (  # noqa: F401 (fixtures)
    hold, tpu_kernels, one_thread)

CFG = dict(model="sepconv", optimizer="Adamax", metasgd=True, inner_lr=1e-5,
           number_of_evaluation_steps_per_iter=1, crop_size=64, mode="val",
           loss="1*L1")

pytestmark = pytest.mark.usefixtures("one_thread", "tpu_kernels")


@pytest.fixture(scope="module")
def clip():
    frames, _ = SyntheticSeptuplet(model="sepconv", mode="val",
                                   size=(64, 64))[0]
    return np.asarray(frames)[None]


@pytest.fixture(scope="module")
def jax_runs(clip):
    """JAX's validation episode in float32 and in bf16, from one init."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        jsys = JaxSystem(JaxConfig(**CFG, dtype=dtype))
        losses, preds = jsys.run_validation_iter(clip)
        out[dtype] = (losses, np.asarray(preds, np.float32),
                      jax.tree.map(np.asarray, jsys.meta_params["net"]))
    return out


def test_sepconv_bf16_validation_episode_matches_jax(jax_runs, clip):
    tsys = SceneAdaptiveInterpolation(Config(**CFG, device="cpu",
                                             dtype="bfloat16"))
    tsys.load_net(bridge.params_from_jax(jax_runs["float32"][2], tsys.model))
    losses, preds = tsys.run_validation_iter(clip)
    assert preds.dtype == torch.float32 and preds.shape == (1, 3, 64, 64)
    jb, jf = jax_runs["bfloat16"], jax_runs["float32"]
    hold(preds.numpy().transpose(0, 2, 3, 1), jb[1], jf[1], "prediction")
    hold(np.float32(losses["loss"]), np.float32(jb[0]["loss"]),
         np.float32(jf[0]["loss"]), "loss")
    # bf16 moved JAX's prediction at all, and the port's with it
    assert np.abs(jb[1] - jf[1]).max() > 0
    assert np.isfinite(losses["psnr"]) and np.isfinite(losses["ssim"])


def test_bf16_system_keeps_float32_masters(clip):
    """The meta-parameters, the Meta-SGD rates, the outer optimizer's state
    and the returned losses and predictions stay float32 under
    --dtype bfloat16; the model's forwards alone are bf16."""
    tsys = SceneAdaptiveInterpolation(Config(**dict(
        CFG, mode="train", batch_size=1, crop_size=32,
        number_of_training_steps_per_iter=1), device="cpu",
        dtype="bfloat16"))
    assert tsys.builder.dtype == torch.bfloat16
    tsys.run_train_iter(clip[:, :, 16:48, 16:48], 0)
    for group, tree in tsys.meta_params.items():
        for k, v in tree.items():
            assert v.dtype == torch.float32, (group, k)
    for state in tsys.outer_opt.state.values():
        for v in state.values():
            assert not torch.is_tensor(v) or v.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in tsys.model.parameters())
