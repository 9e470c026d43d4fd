"""The port's inner optimizers and scene-adaptation episode held against
the JAX package on the CPU (meta_interpolation_tpu_torch/meta/).

One JAX system and one port system, with the JAX init bridged into the
port, are shared by the episode tests (building and compiling the JAX
SepConv episode takes most of this file's time).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meta_interpolation_tpu.config import Config as JaxConfig
from meta_interpolation_tpu.meta import inner_optimizers as jax_inner
from meta_interpolation_tpu.meta.system import (
    SceneAdaptiveInterpolation as JaxSystem)
from meta_interpolation_tpu_torch.config import Config
from meta_interpolation_tpu_torch.core import checkpoint as bridge
from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
from meta_interpolation_tpu_torch.meta import episode
from meta_interpolation_tpu_torch.meta import inner_optimizers as inner
from meta_interpolation_tpu_torch.meta.system import (
    SceneAdaptiveInterpolation)

OPT_RTOL, OPT_ATOL = 1e-6, 1e-9     # same float32 arithmetic, reordered
PRED_ATOL = 1e-4
PRED_OF_RANGE = 1e-3
PSNR_TOL_DB = 1e-3
SSIM_ATOL = 1e-5
LR = 1e-5
# Adamax steps by lr·m/max(β2·u, |g|+eps): about lr·sign(g) wherever
# |g| >> eps, so a gradient within a few eps of zero can flip its step
# under another summation order. Allow that on a tiny share of elements.
STEP_ATOL = 0.1 * LR
STEP_FLIP_SHARE = 1e-5

CFG = dict(model="sepconv", optimizer="Adamax", metasgd=True, inner_lr=LR,
           number_of_evaluation_steps_per_iter=1, crop_size=64, mode="val",
           loss="1*L1")


pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def one_thread():
    """One intra-op thread for this file's PyTorch work: the tier-1 run
    puts six test processes on the machine's cores, where every process
    taking a thread a core oversubscribes them many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("rule", ["SGD", "Adam", "Adamax"])
@pytest.mark.parametrize("lr_mode", ["metasgd", "lslr"])
def test_inner_update_matches_jax(rule, lr_mode):
    """Two consecutive updates (so the state carries over) of each rule."""
    rs = np.random.RandomState(0)
    params = {"a": rs.randn(3, 4).astype(np.float32),
              "b": rs.randn(5).astype(np.float32)}
    jopt = jax_inner.InnerOptimizer(rule=rule, lr_mode=lr_mode, num_steps=2)
    topt = inner.InnerOptimizer(rule=rule, lr_mode=lr_mode, num_steps=2)
    jlrs = jopt.init_lrs(jax.tree.map(jnp.asarray, params), 1e-2)
    lrs = {k: np.asarray(v) * (1.0 + rs.rand(*np.shape(v)))
           for k, v in jlrs.items()}
    jp = jax.tree.map(jnp.asarray, params)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    jstate = jopt.init_state(jp)
    tstate = topt.init_state(tp)
    for step in range(2):
        grads = {k: rs.randn(*v.shape).astype(np.float32)
                 for k, v in params.items()}
        jp, jstate = jopt.update(jp, jax.tree.map(jnp.asarray, grads),
                                 jax.tree.map(jnp.asarray, lrs), jstate, step)
        tp, tstate = topt.update(
            tp, {k: torch.from_numpy(v) for k, v in grads.items()},
            {k: torch.from_numpy(v) for k, v in lrs.items()}, tstate, step)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=OPT_RTOL, atol=OPT_ATOL,
                                       err_msg=f"{rule}/{lr_mode} {k}")


def test_per_step_loss_importance_matches_jax():
    from meta_interpolation_tpu.meta import episode as jax_episode
    for args in [(0, 0, 1), (1, 0, 1), (3, 0, 5), (3, 2, 5), (4, 9, 3)]:
        np.testing.assert_array_equal(
            episode.per_step_loss_importance(*args),
            jax_episode.per_step_loss_importance(*args))


@pytest.fixture(scope="module")
def systems():
    jsys = JaxSystem(JaxConfig(**CFG))
    tsys = SceneAdaptiveInterpolation(Config(**CFG, device="cpu"))
    tsys.load_net(bridge.params_from_jax(
        jax.tree.map(np.asarray, jsys.meta_params["net"]), tsys.model))
    frames, _ = SyntheticSeptuplet(model="sepconv", mode="val",
                                   size=(64, 64))[0]
    return jsys, tsys, np.asarray(frames)[None]


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
        if name.startswith("moduleVertical"):  # inner-frozen subnet
            assert torch.equal(got[name], w0), name
    assert flips <= STEP_FLIP_SHARE * total, (flips, total)
    # the step really moved the encoder (units dead at random init stay)
    assert moved > 0.1 * total, (moved, total)


def test_run_validation_iter_matches_jax(systems):
    jsys, tsys, frames = systems
    j_losses, j_preds = jsys.run_validation_iter(frames)
    t_losses, t_preds = tsys.run_validation_iter(frames)
    assert t_preds.shape == (1, 3, 64, 64)
    got, want = t_preds.numpy().transpose(0, 2, 3, 1), np.asarray(j_preds)
    np.testing.assert_allclose(got, want, atol=PRED_ATOL)
    # random-init predictions are small, so hold them to their range too
    assert np.abs(got - want).max() <= PRED_OF_RANGE * np.abs(want).max()
    assert abs(t_losses["psnr"] - j_losses["psnr"]) <= PSNR_TOL_DB
    assert abs(t_losses["ssim"] - j_losses["ssim"]) <= SSIM_ATOL
    np.testing.assert_allclose(t_losses["loss"], j_losses["loss"],
                               rtol=1e-5)


def test_system_refuses_what_it_does_not_run():
    """--attenuate with --per_step_bn_statistics raises (no JAX episode
    runs both), and so does 'cuda' without a card; per-step BN on a model
    without it is a ValueError, as in JAX, and so is a --dtype other than
    float32 and bfloat16. The bf16 system builds and runs
    (tests/test_torch_bf16_*.py hold it to JAX).
    RRIN and DAIN meta-train since the warp models' training slice
    (tests/test_torch_{rrin,dain}_train.py); L2F and per-step BN run since
    the engine's slice (tests/test_torch_l2f.py,
    tests/test_torch_per_step_bn.py)."""
    for model in ("rrin", "dain"):
        for flags in ({"mode": "train"}, {"second_order": True}):
            system = SceneAdaptiveInterpolation(Config(**dict(
                CFG, model=model, **flags), device="cpu"))
            trains = [k for k, t in system.trainable["net"].items() if t]
            assert trains and all(model == "rrin" or k.startswith(
                "rectifyNet.") for k in trains)
    bf16 = SceneAdaptiveInterpolation(Config(**CFG, device="cpu",
                                             dtype="bfloat16"))
    assert bf16.builder.dtype == torch.bfloat16
    frames, _ = SyntheticSeptuplet(model="sepconv", mode="val",
                                   size=(32, 32))[0]
    losses, preds = bf16.run_validation_iter(np.asarray(frames)[None])
    assert preds.dtype == torch.float32 and np.isfinite(losses["psnr"])
    with pytest.raises(ValueError, match="--dtype"):
        SceneAdaptiveInterpolation(Config(**CFG, device="cpu",
                                          dtype="float16"))
    with pytest.raises(ValueError, match="--per_step_bn_statistics"):
        SceneAdaptiveInterpolation(Config(**CFG, device="cpu",
                                          per_step_bn_statistics=True))
    with pytest.raises(NotImplementedError, match="--attenuate"):
        SceneAdaptiveInterpolation(Config(**CFG, device="cpu",
                                          attenuate=True,
                                          per_step_bn_statistics=True))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SceneAdaptiveInterpolation(Config(**CFG, device="cuda"))
