"""The port's VoxelFlow scene-adaptive evaluation held against the JAX
system on the CPU: run_voxelflow.sh (Adam, Meta-SGD, 1*MSE, 1 + 1 steps)
with --fast_warp_range 4 and as it is (the exact warp); the CLI; and the
training CLI refusing it. SuperSloMo's cases (run_superslomo.sh: the same
with 1*Super) are in tests/test_torch_superslomo_episode.py, which shares
this file's presets and helpers: in a file of their own, another test
process runs them beside these.

Each test builds a JAX system and a port system, with the JAX init (and,
for the Super loss, JAX's VGG16 weights) bridged into the port. The JAX
systems run their episodes op by op (``jit_episode=False``, a flag of the
JAX package): the bounded warp's unrolled (2R + 2)² sweep and its gradient
make a jitted episode compile for minutes, while the op-by-op episodes
share their compiled primitives across the tests of this file, the exact
episode of each model running first.
"""
import inspect

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
from meta_interpolation_tpu_torch.main import main
from meta_interpolation_tpu_torch.meta.system import (
    SceneAdaptiveInterpolation)
from meta_interpolation_tpu_torch.ops import warp_bounded as wb

PRED_ATOL = 1e-4
PSNR_TOL_DB = 1e-3
SSIM_ATOL = 1e-5
LOSS_RTOL = 1e-5
CROP = 64

PRESETS = {
    "superslomo": dict(model="superslomo", loss="1*Super", optimizer="Adam",
                       metasgd=True, inner_lr=1e-5,
                       number_of_training_steps_per_iter=1,
                       number_of_evaluation_steps_per_iter=1,
                       crop_size=CROP, mode="val"),
    "voxelflow": dict(model="voxelflow", loss="1*MSE", optimizer="Adam",
                      metasgd=True, inner_lr=1e-5,
                      number_of_training_steps_per_iter=1,
                      number_of_evaluation_steps_per_iter=1,
                      crop_size=CROP, mode="val"),
}

pytestmark = pytest.mark.usefixtures("two_threads")


@pytest.fixture(scope="module")
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _systems(cfg):
    jsys = JaxSystem(JaxConfig(**cfg, jit_episode=False))
    tsys = SceneAdaptiveInterpolation(Config(**cfg, device="cpu"))
    tsys.load_net(bridge.params_from_jax(
        jax.tree.map(np.asarray, jsys.meta_params["net"]), tsys.model))
    jvgg = inspect.getclosurevars(jsys.loss_fn).nonlocals.get("vgg16_params")
    if jvgg is not None:
        tsys.loss_fn.vgg16_params = bridge.vgg16_params_from_jax(
            jax.tree.map(np.asarray, jvgg))
    frames, _ = SyntheticSeptuplet(model=cfg["model"], mode="val",
                                   size=(CROP, CROP))[0]
    return jsys, tsys, np.asarray(frames)[None]


def _hold_episode_to_jax(jsys, tsys, frames):
    j_losses, j_preds = jsys.run_validation_iter(frames)
    t_losses, t_preds = tsys.run_validation_iter(frames)
    assert t_preds.shape == (1, 3, CROP, CROP)
    got, want = t_preds.numpy().transpose(0, 2, 3, 1), np.asarray(j_preds)
    np.testing.assert_allclose(got, want, atol=PRED_ATOL)
    assert abs(t_losses["psnr"] - j_losses["psnr"]) <= PSNR_TOL_DB
    assert abs(t_losses["ssim"] - j_losses["ssim"]) <= SSIM_ATOL
    np.testing.assert_allclose(t_losses["loss"], j_losses["loss"],
                               rtol=LOSS_RTOL)


def hold_preset_to_jax(model, warp_range):
    """The preset plus --fast_warp_range ``warp_range`` (0: as it is, the
    exact F.grid_sample), its episode held to JAX's."""
    jsys, tsys, frames = _systems(dict(PRESETS[model],
                                       fast_warp_range=warp_range))
    assert tsys.model.warp_range == (warp_range or None)
    assert tsys.builder.returns_aux == (model == "superslomo")
    assert (tsys.loss_fn.vgg16_params is not None) == (model == "superslomo")
    _hold_episode_to_jax(jsys, tsys, frames)


@pytest.mark.parametrize("model,warp_range", [
    ("voxelflow", 0), ("voxelflow", 4)])
def test_run_validation_iter_matches_jax(model, warp_range):
    hold_preset_to_jax(model, warp_range)


def run_cli_on_the_cpu(model, eval_steps, tmp_path, capsys):
    """The 8 synthetic clips through the CLI. Both models pad a 32x32 crop
    to 64x64; SuperSloMo's clips take the query only (its Super loss and
    aux included), since 8 full episodes of two 40 M-parameter U-Nets
    would cost more CPU seconds than the episode tests, which hold its
    adaptation."""
    cfg = PRESETS[model]
    wb.reset_launches()
    stats = main(["--model", model, "--mode", "val", "--dataset",
                  "synthetic", "--crop_size", "32", "--optimizer", "Adam",
                  "--metasgd", "--inner_lr", "1e-5", "--loss", cfg["loss"],
                  "--number_of_training_steps_per_iter", "1",
                  "--number_of_evaluation_steps_per_iter", str(eval_steps),
                  "--val_batch_size", "1", "--fast_warp_range", "4",
                  "--checkpoint_dir", str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "device: cpu" in out
    assert out.count("[val epoch 0] loss") == 1
    assert np.isfinite(stats["psnr"]) and np.isfinite(stats["ssim"])
    # the CPU path runs the plain versions, never a kernel
    assert wb.warp_sample_bounded_forward.launches == 0
    assert wb.warp_sample_bounded_grad_grid.launches == 0


@pytest.mark.parametrize("model,eval_steps", [("voxelflow", 1)])
def test_cli_val_runs_on_the_cpu(model, eval_steps, tmp_path, capsys):
    run_cli_on_the_cpu(model, eval_steps, tmp_path, capsys)


def refuse_training(model, tmp_path):
    with pytest.raises(NotImplementedError,
                       match=f"meta-training .* of '{model}'"):
        main(["--model", model, "--mode", "train", "--dataset", "synthetic",
              "--crop_size", "32", "--checkpoint_dir", str(tmp_path),
              "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="--per_step_bn_statistics"):
        SceneAdaptiveInterpolation(Config(**PRESETS["voxelflow"],
                                          per_step_bn_statistics=True,
                                          device="cpu"))


@pytest.mark.parametrize("model", ["voxelflow"])
def test_training_is_refused(model, tmp_path):
    refuse_training(model, tmp_path)
