"""The port's per-step batch norm statistics (``--per_step_bn_statistics``)
held against the JAX package on the CPU: the meta batch norm function,
per-step and flat; VoxelFlow's forward with a ``bn_state`` in both affine
combinations; a batch-3 training iteration's statistics against JAX's
closed-form sequential fold and its outer gradient, in both orders;
evaluation and ×2 slow motion leaving the statistics as they were;
``--resume``; the refusals; and the CLI.

VoxelFlow (run_voxelflow.sh: Adam, Meta-SGD, 1*MSE, one inner step) at
crop 32 on the exact warp, JAX op by op. Limits as PERF.md §2: the
statistics within 1e-5 (absolute; they are O(1)), predictions 1e-4, PSNR
1e-3 dB, the outer loss 1e-5 relative, each tensor's outer gradient within
1e-3 of its norm at the inner SGD rule and each group's after an inner
Adam step (~lr·sign(g), see tests/test_torch_warp_train.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meta_interpolation_tpu.config import Config as JaxConfig
from meta_interpolation_tpu.meta import episode as jax_episode
from meta_interpolation_tpu.meta.system import (
    SceneAdaptiveInterpolation as JaxSystem)
from meta_interpolation_tpu.models import layers as jax_layers
from meta_interpolation_tpu.models import voxelflow as jax_vf
from meta_interpolation_tpu_torch.config import Config
from meta_interpolation_tpu_torch.core import checkpoint as bridge
from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
from meta_interpolation_tpu_torch.main import main
from meta_interpolation_tpu_torch.meta.system import (
    SceneAdaptiveInterpolation)
from meta_interpolation_tpu_torch.models import layers
from meta_interpolation_tpu_torch.models.voxelflow import (
    VoxelFlow, init_bn_state)

STATS_ATOL = 1e-5
PRED_ATOL = 1e-4
PSNR_TOL_DB = 1e-3
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-3
CROP = 32
PRESET = dict(model="voxelflow", loss="1*MSE", optimizer="Adam",
              metasgd=True, inner_lr=1e-5, outer_lr=1e-5,
              number_of_training_steps_per_iter=1,
              number_of_evaluation_steps_per_iter=1, crop_size=CROP,
              mode="train", batch_size=3, per_step_bn_statistics=True)

pytestmark = pytest.mark.usefixtures("two_threads")


@pytest.fixture(scope="module")
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x).transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("per_step", [True, False])
def test_meta_batch_norm_matches_jax(per_step):
    """Batch-statistics normalisation and the running update at row 1 (or
    the flat one, whose variance starts at zeros), on a batch of one 5x7
    map, where the unbiased factor n/(n − 1) is 35/34."""
    rs = np.random.RandomState(0)
    x = rs.randn(1, 5, 7, 4).astype(np.float32) * 3 + 1
    init = jax_layers.meta_batch_norm_init(4, 3, per_step=per_step)
    p = {k: np.asarray(v) + (0.1 * rs.randn(*np.shape(v))).astype(
        np.float32) * (k in ("weight", "bias")) for k, v in init.items()}
    out, new = jax_layers.meta_batch_norm_apply(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), num_step=1,
        per_step=per_step)
    mean, var = layers.meta_batch_norm_init(4, 3, per_step=per_step)
    np.testing.assert_array_equal(mean.numpy(), p["running_mean"])
    np.testing.assert_array_equal(var.numpy(), p["running_var"])
    w, b = (p["weight"][1], p["bias"][1]) if per_step else (p["weight"],
                                                            p["bias"])
    got, (g_mean, g_var) = layers.meta_batch_norm(
        nchw(x), torch.tensor(w), torch.tensor(b), mean, var, num_step=1,
        per_step=per_step)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(out), atol=1e-5)
    np.testing.assert_allclose(g_mean.numpy(),
                               np.asarray(new["running_mean"]), atol=1e-6)
    np.testing.assert_allclose(g_var.numpy(), np.asarray(new["running_var"]),
                               atol=1e-5)


def bn_from_jax(tree):
    return bridge.bn_state_from_jax(jax.tree.map(np.asarray, tree))


@pytest.mark.parametrize("per_step_affine", [2, 0])
def test_voxelflow_forward_with_bn_state_matches_jax(per_step_affine):
    """VoxelFlow's forward at num_step 1 from a perturbed state: the
    prediction and every updated row, with the per-step affine rows (the
    reference's combination without
    --enable_inner_loop_optimizable_bn_params) or the flat affine."""
    params = jax_vf.init(jax.random.PRNGKey(1),
                         per_step_bn_affine=per_step_affine)
    rs = np.random.RandomState(2)
    params = jax.tree.map(
        lambda a: jnp.asarray(np.asarray(a) * (1 + 0.2 * rs.rand(
            *np.shape(a)))).astype(jnp.float32), params)
    state = jax.tree.map(lambda a: a + 0.3 * jnp.asarray(rs.rand(
        *a.shape), jnp.float32), jax_vf.init_bn_state(2))
    f0, f1 = (rs.rand(1, CROP, 48, 3).astype(np.float32) for _ in range(2))
    pred, new = jax_vf.apply(params, jnp.asarray(f0), jnp.asarray(f1),
                             bn_state=state, num_step=1, warp_range=4)
    model = VoxelFlow(warp_range=4, per_step_bn_affine=per_step_affine)
    model.load_state_dict(bridge.params_from_jax(
        jax.tree.map(np.asarray, params), model))
    got, got_state = model(nchw(f0), nchw(f1), bn_state=bn_from_jax(state),
                           num_step=1)
    np.testing.assert_allclose(got.detach().numpy().transpose(0, 2, 3, 1),
                               np.asarray(pred), atol=PRED_ATOL)
    want = bn_from_jax(new)
    assert set(got_state) == set(want) == set(init_bn_state(2))
    for k, v in want.items():
        np.testing.assert_allclose(got_state[k].numpy(), v.numpy(),
                                   atol=STATS_ATOL, err_msg=k)
        assert not got_state[k].requires_grad
    # row 0 is untouched, row 1 moved
    k = "conv1_bn.running_mean"
    assert torch.equal(got_state[k][0], bn_from_jax(state)[k][0])
    assert not torch.equal(got_state[k][1], bn_from_jax(state)[k][1])


def clips(n, mode="train", crop=CROP):
    data = SyntheticSeptuplet(model="voxelflow", mode=mode,
                              size=(crop, crop))
    return np.stack([np.asarray(data[i][0]) for i in range(n)])


def systems(**extra):
    cfg = dict(PRESET, **extra)
    jsys = JaxSystem(JaxConfig(**cfg, jit_episode=False))
    tsys = SceneAdaptiveInterpolation(Config(**cfg, device="cpu"))
    bridge.load_jax_meta_params(tsys, jax.tree.map(np.asarray,
                                                   jsys.meta_params))
    return jsys, tsys


@pytest.fixture(scope="module")
def frames():
    return clips(3)


@pytest.mark.parametrize("order", ["first", "second"])
def test_train_iteration_matches_jax(order, frames):
    """run_train_iter at batch 3: the statistics written back against JAX's
    fold of its vmapped tasks (the sequential composition in closed form,
    ``fold_bn_states_sequential``), and the outer loss and gradient it
    took (first order at the preset's inner Adam; second order at the
    inner SGD rule)."""
    extra = ({} if order == "first" else
             dict(optimizer="SGD", second_order=True))
    jsys, tsys = systems(**extra)
    spec = jsys._episode_spec("train", 1, order == "second", False)
    msl_w = jnp.ones((1,))

    def outer(mp, task):
        out = jsys.builder.task_episode(mp, task, msl_w, spec,
                                        training=True)
        return out[0], out[-1]

    runs = [jax.value_and_grad(outer, has_aux=True)(
        jsys.meta_params, jnp.asarray(task)) for task in frames]
    want_loss = sum(float(o) for (o, _), _ in runs) / len(runs)
    want = jax.tree.map(lambda *g: np.asarray(sum(g) / len(g)),
                        *[g for _, g in runs])
    folded = jax_episode.fold_bn_states_sequential(
        jsys.meta_params["bn_state"],
        jax.tree.map(lambda *s: jnp.stack(s), *[b for (_, b), _ in runs]),
        spec)
    taken = []
    port_grads = tsys.outer_grads
    tsys.outer_grads = lambda *a: taken.append(port_grads(*a)) or taken[-1]
    before = {k: v.clone() for k, v in tsys.meta_params["bn_state"].items()}
    tsys.run_train_iter(frames, 0)
    loss, aux, got = taken[0]
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    for k, v in bn_from_jax(folded).items():
        np.testing.assert_allclose(tsys.meta_params["bn_state"][k].numpy(),
                                   v.numpy(), atol=STATS_ATOL, err_msg=k)
        assert not torch.equal(tsys.meta_params["bn_state"][k], before[k])
        assert torch.equal(tsys.meta_params["bn_state"][k],
                           aux["bn_state"][k])
    per_tensor = order == "second"
    for group in ("net", "lrs"):
        ref = bridge.params_from_jax(want[group], tsys.model)
        pairs = [(k, got[group][k], ref[k]) for k in tsys.meta_params[group]]
        if not per_tensor:
            pairs = [(group, torch.cat([g.flatten() for _, g, _ in pairs]),
                      torch.cat([w.flatten() for _, _, w in pairs]))]
        for name, g, w in pairs:
            err = float((g - w).norm())
            assert err <= GRAD_RTOL * float(w.norm()) + 1e-12, (
                group, name, err, float(w.norm()))
    # the per-step affine rows train in the outer loop (never inner-adapted:
    # their rate's gradient is zero), the statistics never
    assert tuple(tsys.meta_params["net"]["conv1_bn.weight"].shape) == (1, 64)
    assert float(got["net"]["conv1_bn.weight"].norm()) > 0
    assert float(got["lrs"]["conv1_bn.weight"].abs().max()) == 0.0
    assert not any(tsys.trainable["bn_state"].values())


def test_evaluation_and_slow_motion_leave_the_state_unchanged():
    """run_validation_iter and run_test_iter against JAX's, from a
    perturbed state: the predictions agree and the statistics are as they
    were (each task starts from them and its own are dropped). At crop 64,
    as tests/test_torch_warp_models_episode.py holds the evaluation: at
    crop 32 one pixel's 8-bit level flipping at a rounding tie moves the
    PSNR by ~7e-4 dB."""
    rs = np.random.RandomState(3)
    jsys, tsys = systems(batch_size=1, crop_size=64)
    jsys.meta_params["bn_state"] = jax.tree.map(
        lambda a: a + jnp.asarray(rs.rand(*a.shape), jnp.float32),
        jsys.meta_params["bn_state"])
    bridge.load_jax_meta_params(tsys, jax.tree.map(np.asarray,
                                                   jsys.meta_params))
    before = {k: v.clone() for k, v in tsys.meta_params["bn_state"].items()}
    val = clips(1, "val", crop=64)
    j_losses, j_preds = jsys.run_validation_iter(val)
    t_losses, t_preds = tsys.run_validation_iter(val)
    np.testing.assert_allclose(t_preds.numpy().transpose(0, 2, 3, 1),
                               np.asarray(j_preds), atol=PRED_ATOL)
    assert abs(t_losses["psnr"] - j_losses["psnr"]) <= PSNR_TOL_DB
    quad = val[:, 1:5]
    want = jsys.run_test_iter(quad)
    got = tsys.run_test_iter(quad)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), atol=PRED_ATOL)
    for k, v in before.items():
        assert torch.equal(tsys.meta_params["bn_state"][k], v), k


def test_resume_carries_the_state(tmp_path, frames):
    """A checkpoint written after a training iteration and read into a
    fresh system gives back the statistics bit for bit."""
    cfg = Config(**dict(PRESET, batch_size=1), device="cpu")
    trained = SceneAdaptiveInterpolation(cfg)
    trained.run_train_iter(frames[:1], 0)
    bridge.save_checkpoint({"system": trained.state_dict()}, str(tmp_path))
    resumed = SceneAdaptiveInterpolation(cfg)
    resumed.load_state_dict(bridge.load_checkpoint(str(tmp_path))["system"])
    for k, v in trained.meta_params["bn_state"].items():
        assert torch.equal(resumed.meta_params["bn_state"][k], v), k
        assert not torch.equal(v, init_bn_state(1)[k]), k
    (tmp_path / "checkpoint.pth").unlink()


@pytest.mark.parametrize("extra,match", [
    (dict(model="rrin", loss="1*L1", metasgd=False,
          number_of_training_steps_per_iter=0), "no per-step BN support"),
    (dict(number_of_training_steps_per_iter=0, metasgd=True),
     "requires number_of_training_steps_per_iter >= 1")])
def test_refused_as_jax_refuses(extra, match):
    cfg = dict(PRESET, **extra)
    for build in (lambda: JaxSystem(JaxConfig(**cfg)),
                  lambda: SceneAdaptiveInterpolation(Config(
                      **cfg, device="cpu"))):
        with pytest.raises(ValueError, match=match):
            build()


def test_cli_trains_with_per_step_statistics_on_the_cpu(tmp_path, capsys):
    """The training CLI on the bounded warp: two iterations, a validation
    and a checkpoint holding the moved statistics; without a card,
    --device cuda raises."""
    argv = ["--model", "voxelflow", "--mode", "train", "--dataset",
            "synthetic", "--crop_size", str(CROP), "--batch_size", "2",
            "--optimizer", "Adam", "--metasgd", "--loss", "1*MSE",
            "--inner_lr", "1e-5", "--outer_lr", "1e-5",
            "--number_of_training_steps_per_iter", "1",
            "--number_of_evaluation_steps_per_iter", "1",
            "--fast_warp_range", "4", "--per_step_bn_statistics",
            "--max_epoch", "1", "--total_iter_per_epoch", "2",
            "--checkpoint_dir", str(tmp_path)]
    stats = main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "[epoch 0 it 0] loss" in out and "[val epoch 0]" in out
    assert np.isfinite(stats["best_psnr"])
    state = bridge.load_checkpoint(str(tmp_path / "exp"))["system"]
    moved = state["meta_params"]["bn_state"]["deconv3_bn.running_var"]
    assert moved.shape == (1, 64) and not torch.equal(moved,
                                                      torch.ones(1, 64))
    for path in tmp_path.rglob("*.pth"):   # weights read: free the disk
        path.unlink()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv + ["--device", "cuda"])
