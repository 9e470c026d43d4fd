"""The port's DAIN system held against the JAX system on the CPU in
float32: ``run_validation_iter`` on a 64×64 synthetic clip with the
scripts/run_dain.sh hyperparameters (Adamax, Meta-SGD, inner lr 1e-5, 1
training and 1 evaluation step), tamed random weights bridged from JAX.
The float64 evaluation step and the CLI are in
tests/test_torch_dain_episode.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meta_interpolation_tpu.config import Config as JaxConfig
from meta_interpolation_tpu.meta.system import (
    SceneAdaptiveInterpolation as JaxSystem)
from meta_interpolation_tpu.models.dain import model as jax_dain
from meta_interpolation_tpu_torch.config import Config
from meta_interpolation_tpu_torch.core import checkpoint as bridge
from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
from meta_interpolation_tpu_torch.meta.system import (
    SceneAdaptiveInterpolation)

CFG = dict(model="dain", optimizer="Adamax", metasgd=True, inner_lr=1e-5,
           loss="1*L1", number_of_training_steps_per_iter=1,
           number_of_evaluation_steps_per_iter=1, val_batch_size=1,
           crop_size=64, mode="val")
# float32 with another summation order through ~20 convolution layers and
# a 437-channel 7×7 one, relative to the frame's largest magnitude (the
# random-init rectify residual makes it ~35): measured max|Δ| 1.1e-4,
# 3.2e-6 of it, at one pixel. A floor flip (a flow within ~1e-6 of a cell
# boundary) would show as a local jump of order 1, far above the limit.
PRED_RTOL = 1e-5
PSNR_TOL_DB = 1e-3


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads while this file runs: the tier-1 run puts six
    test files side by side on one host, and DAIN's CPU forwards with a
    thread per core each slow every file down."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tamed_jax_params():
    p = jax_dain.init(jax.random.PRNGKey(0))
    last = str(max(int(k) for k in p["depthNet"]))
    p["depthNet"][last]["kernel"] = p["depthNet"][last]["kernel"] * 1e-4
    p["depthNet"][last]["bias"] = p["depthNet"][last]["bias"] * 0.0
    return jax.tree.map(np.asarray, p)


@pytest.fixture(scope="module")
def systems():
    jax_params = _tamed_jax_params()
    jsys = JaxSystem(JaxConfig(**CFG))
    jsys.meta_params["net"] = jax.tree.map(jnp.asarray, jax_params)
    tsys = SceneAdaptiveInterpolation(Config(**CFG, device="cpu"))
    tsys.load_net(bridge.params_from_jax(jax_params, tsys.model))
    frames, _ = SyntheticSeptuplet(model="dain", mode="val",
                                   size=(64, 64))[0]
    return jsys, tsys, np.asarray(frames)[None]


def test_system_takes_the_dain_preset(systems):
    """Charbonnier whatever --loss says, hole filling on every forward,
    and only rectifyNet adapted."""
    _, tsys, _ = systems
    assert tsys.builder.apply_kwargs == {"fill_holes": True}
    pred = np.zeros((1, 3, 4, 4), np.float32)
    losses = tsys.loss_fn(torch.from_numpy(pred),
                          torch.from_numpy(pred + 0.5))
    assert set(losses) == {"DAIN", "total"}
    np.testing.assert_allclose(float(losses["total"]),
                               np.sqrt(0.25 + 1e-8), rtol=1e-6)
    live = {k for k, v in tsys.builder.inner_keep.items() if v}
    assert live and all(k.startswith("rectifyNet.") for k in live)


def test_run_validation_iter_matches_jax(systems):
    jsys, tsys, frames = systems
    j_losses, j_preds = jsys.run_validation_iter(frames)
    t_losses, t_preds = tsys.run_validation_iter(frames)
    got, want = t_preds.numpy().transpose(0, 2, 3, 1), np.asarray(j_preds)
    assert got.shape == (1, 64, 64, 3)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=PRED_RTOL * float(np.abs(want).max()))
    assert abs(t_losses["psnr"] - j_losses["psnr"]) <= PSNR_TOL_DB
    np.testing.assert_allclose(t_losses["loss"], j_losses["loss"], rtol=1e-5)
