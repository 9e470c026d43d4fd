"""The port's VoxelFlow scene-adaptive evaluation held against the JAX
system on the CPU: run_voxelflow.sh (Adam, Meta-SGD, 1*MSE, 1 + 1 steps)
with --fast_warp_range 4 and as it is (the exact warp); the CLI, in
evaluation and in training (first and second order), and the training
flags the port refuses. SuperSloMo's cases (run_superslomo.sh: the same
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


TRAIN_FLAGS = {
    "rrin": ["--optimizer", "Adam", "--loss", "1*L1",
             "--number_of_training_steps_per_iter", "0",
             "--number_of_evaluation_steps_per_iter", "0"],
    "superslomo": ["--optimizer", "Adam", "--metasgd", "--loss", "1*Super",
                   "--number_of_training_steps_per_iter", "1",
                   "--number_of_evaluation_steps_per_iter", "1"],
    "voxelflow": ["--optimizer", "Adam", "--metasgd", "--loss", "1*MSE",
                  "--number_of_training_steps_per_iter", "1",
                  "--number_of_evaluation_steps_per_iter", "1"],
    "dain": ["--optimizer", "Adamax", "--metasgd", "--loss", "1*L1",
             "--number_of_training_steps_per_iter", "1",
             "--number_of_evaluation_steps_per_iter", "1"],
}


def train_flags(model, tmp_path, *extra):
    """The model's preset in training at crop 32 on the synthetic clips, one
    epoch of 2 iterations of batch 1 (the warp models on
    --fast_warp_range 4)."""
    flags = ["--model", model, "--mode", "train", "--dataset", "synthetic",
             "--crop_size", "32", "--batch_size", "1", "--inner_lr", "1e-5",
             "--outer_lr", "1e-5", "--max_epoch", "1",
             "--total_iter_per_epoch", "2", "--checkpoint_dir",
             str(tmp_path), *TRAIN_FLAGS[model], *extra]
    if model == "dain":
        # tamed random weights: the random-init depth net overflows
        from meta_interpolation_tpu_torch.models.dain.model import (
            DAIN, tame_depth_head_)
        pth = tmp_path / "dain.pth"
        torch.save(tame_depth_head_(DAIN(torch.Generator().manual_seed(0)))
                   .state_dict(), pth)
        flags += ["--pretrained_model", str(pth)]
    else:
        flags += ["--fast_warp_range", "4"]
    return flags


def train_cli_on_the_cpu(model, order, tmp_path, capsys):
    """The training CLI with --device cpu: two iterations, their validation
    clips and a checkpoint, finite losses; the CPU path launches no kernel.
    Without a card, --device cuda raises instead of falling back."""
    extra = ["--second_order"] if order == "second" else []
    wb.reset_launches()
    stats = main(train_flags(model, tmp_path, *extra, "--device", "cpu"))
    out = capsys.readouterr().out
    assert "device: cpu" in out and "[epoch 0 it 0] loss" in out
    assert out.count("[val epoch 0] loss") == 1
    assert np.isfinite(stats["best_psnr"])
    assert (tmp_path / "exp" / "checkpoint.pth").exists()
    assert not any(getattr(wb, k).launches for k in (
        "warp_sample_bounded_forward", "warp_sample_bounded_grad_grid",
        "warp_sample_bounded_grad_grid_backward"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(train_flags(model, tmp_path, *extra, "--device", "cuda"))
    remove_pth(tmp_path)


def remove_pth(root):
    """Delete every .pth under ``root`` once the test has read them: a
    full run's checkpoints would fill the disk (SuperSloMo's is 951 MB,
    and a best run copies it)."""
    for path in root.rglob("*.pth"):
        path.unlink()


@pytest.mark.parametrize("order", ["first", "second"])
def test_cli_trains_voxelflow_on_the_cpu(order, tmp_path, capsys):
    train_cli_on_the_cpu("voxelflow", order, tmp_path, capsys)


def refuse_training(model, tmp_path):
    """What the training CLI still refuses for the model (ROADMAP Queue
    1): --dtype bfloat16, and L2F's --attenuate with
    --per_step_bn_statistics, which no JAX episode runs together."""
    for flags in (("--dtype", "bfloat16"),
                  ("--attenuate", "--per_step_bn_statistics")):
        with pytest.raises(NotImplementedError, match=" ".join(flags[:2])
                           if flags[0] == "--dtype" else flags[0]):
            main(train_flags(model, tmp_path, *flags, "--device", "cpu"))


@pytest.mark.parametrize("model", ["voxelflow"])
def test_training_is_refused(model, tmp_path):
    """Meta-training runs since the port's training slice of the warp
    models; what stays refused is refused."""
    refuse_training(model, tmp_path)


@pytest.mark.parametrize("flag", ["attenuate", "per_step_bn_statistics"])
def test_unported_training_flag_is_refused(flag):
    """Each flag trains alone since the engine's slice; with the other it
    is refused, as no JAX episode runs the two together."""
    other = ({"attenuate", "per_step_bn_statistics"} - {flag}).pop()
    with pytest.raises(NotImplementedError, match="--attenuate with "
                       "--per_step_bn_statistics"):
        SceneAdaptiveInterpolation(Config(**dict(
            PRESETS["voxelflow"], mode="train", **{flag: True, other: True}),
            device="cpu"))
    system = SceneAdaptiveInterpolation(Config(**dict(
        PRESETS["voxelflow"], mode="train", **{flag: True}), device="cpu"))
    group = "attenuator" if flag == "attenuate" else "bn_state"
    assert group in system.meta_params
