"""The port's RRIN scene-adaptive evaluation held against the JAX system on
the CPU: the run_rrin.sh hyperparameters (Adam inner rule, LSLR with 0
training steps, 1*L1) with one evaluation step and the bounded warp, the
preset as it is (0 evaluation steps, exact warp), and the CLI.

One JAX system and one port system, with the JAX init bridged into the
port, are shared by the episode tests.
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
from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
from meta_interpolation_tpu_torch.main import main
from meta_interpolation_tpu_torch.meta import episode
from meta_interpolation_tpu_torch.meta.system import (
    SceneAdaptiveInterpolation)
from meta_interpolation_tpu_torch.ops import warp_bounded as wb

PRED_ATOL = 1e-4
PSNR_TOL_DB = 1e-3
SSIM_ATOL = 1e-5
LR = 1e-5
# Adam's first step is lr·m̂/(√v̂ + eps) = lr·g/(|g| + eps), about lr·sign(g)
# wherever |g| >> eps, so a gradient within a few eps of zero can flip its
# step under another summation order. Allow that on a tiny share.
STEP_ATOL = 0.1 * LR
STEP_FLIP_SHARE = 1e-5

PRESET = dict(model="rrin", optimizer="Adam", inner_lr=LR, loss="1*L1",
              number_of_training_steps_per_iter=0,
              number_of_evaluation_steps_per_iter=0, crop_size=64,
              mode="val")
CFG = dict(PRESET, number_of_evaluation_steps_per_iter=1, fast_warp_range=4)


pytestmark = pytest.mark.usefixtures("two_threads")


@pytest.fixture(scope="module")
def two_threads():
    """Two intra-op threads for this file's PyTorch work: the tier-1 run
    puts six test processes on the machine's cores, where every process
    taking a thread a core oversubscribes them many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _systems(cfg):
    jsys = JaxSystem(JaxConfig(**cfg))
    tsys = SceneAdaptiveInterpolation(Config(**cfg, device="cpu"))
    tsys.load_net(bridge.params_from_jax(
        jax.tree.map(np.asarray, jsys.meta_params["net"]), tsys.model))
    frames, _ = SyntheticSeptuplet(model="rrin", mode="val",
                                   size=(64, 64))[0]
    return jsys, tsys, np.asarray(frames)[None]


@pytest.fixture(scope="module")
def systems():
    return _systems(CFG)


def _hold_episode_to_jax(jsys, tsys, frames):
    j_losses, j_preds = jsys.run_validation_iter(frames)
    t_losses, t_preds = tsys.run_validation_iter(frames)
    assert t_preds.shape == (1, 3, 64, 64)
    got, want = t_preds.numpy().transpose(0, 2, 3, 1), np.asarray(j_preds)
    np.testing.assert_allclose(got, want, atol=PRED_ATOL)
    assert abs(t_losses["psnr"] - j_losses["psnr"]) <= PSNR_TOL_DB
    assert abs(t_losses["ssim"] - j_losses["ssim"]) <= SSIM_ATOL
    np.testing.assert_allclose(t_losses["loss"], j_losses["loss"],
                               rtol=1e-5)


def test_system_takes_the_preset(systems):
    _, tsys, _ = systems
    assert tsys.model.warp_range == 4
    assert tsys.inner_opt.lr_mode == "lslr"
    assert {tuple(v.shape) for v in tsys.meta_params["lrs"].values()} == {
        (1,)}


def test_adapted_params_match_jax(systems):
    jsys, tsys, frames = systems
    jspec = jsys._episode_spec("train", 1, False, True)
    adapt = jax.jit(lambda net, lrs, f: jsys.builder.adapt(net, lrs, f,
                                                          jspec)[0])
    want = bridge.params_from_jax(jax.tree.map(np.asarray, adapt(
        jsys.meta_params["net"], jsys.meta_params["lrs"],
        jnp.asarray(frames[0]))), tsys.model)
    spec = episode.EpisodeSpec(support_idxs=tsys.cfg.support_idxs("train"),
                               num_steps=1)
    init = tsys.meta_params["net"]
    got = tsys.builder.adapt(init, tsys.meta_params["lrs"],
                             tsys._frames(frames)[0], spec)
    flips = total = moved = 0
    for name, w0 in init.items():
        d_got, d_want = got[name] - w0, want[name] - w0
        diff = (d_got - d_want).abs()
        assert float(diff.max()) <= 2 * LR, name
        flips += int((diff > STEP_ATOL).sum())
        total += diff.numel()
        moved += int((d_got.abs() > 0.5 * LR).sum())
        if name.startswith("Mask."):  # inner-frozen U-Net
            assert (d_got == 0).all(), name
    assert flips <= STEP_FLIP_SHARE * total, (flips, total)
    # the step really moved the weights (units dead at random init stay)
    assert moved > 0.1 * total, (moved, total)


def test_run_validation_iter_matches_jax(systems):
    _hold_episode_to_jax(*systems)


def test_preset_as_is_matches_jax():
    """run_rrin.sh unchanged: 0 evaluation steps, the exact warp."""
    jsys, tsys, frames = _systems(PRESET)
    assert tsys.model.warp_range is None
    _hold_episode_to_jax(jsys, tsys, frames)


def test_cli_val_runs_rrin_on_the_cpu(tmp_path, capsys):
    wb.reset_launches()
    stats = main(["--model", "rrin", "--mode", "val", "--dataset",
                  "synthetic", "--crop_size", "64", "--optimizer", "Adam",
                  "--inner_lr", "1e-5", "--loss", "1*L1",
                  "--number_of_training_steps_per_iter", "0",
                  "--number_of_evaluation_steps_per_iter", "1",
                  "--val_batch_size", "1", "--fast_warp_range", "4",
                  "--checkpoint_dir", str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "device: cpu" in out
    assert out.count("[val epoch 0] loss") == 1
    assert np.isfinite(stats["psnr"]) and np.isfinite(stats["ssim"])
    # the CPU path runs the plain versions, never a kernel
    assert wb.warp_sample_bounded_forward.launches == 0
    assert wb.warp_sample_bounded_grad_grid.launches == 0
    for path in tmp_path.rglob("*.pth"):   # weights read: free the disk
        path.unlink()
