"""The port's adversarial losses (meta_interpolation_tpu_torch/core/
adversarial.py and the GAN terms of core/losses.py) held against the JAX
package on the CPU: the discriminator's forward with its center crop and
its pad, the generator term of each type, one discriminator update of each
type with WGAN-GP's interpolation weights handed across, WGAN's clamp, the
--disc_per_forward replay order and its steps, and the CLI; the
meta-training iterations are in tests/test_torch_adversarial_train.py.

The discriminator's weights are the JAX init, bridged
(``core/checkpoint.disc_params_from_jax``). Limits: forwards and losses
to 1e-5 of the largest value, the generator term's input gradient to 1e-4
in norm (float32 in another summation order; in float64 the two
discriminators agree to 1e-14, values and gradients). After a
discriminator step: Adam's first steps are ~lr·sign(g), so an element
whose gradient is within rounding of zero may step the other way: each
parameter within 2.5·lr, and at most STEP_FLIP_SHARE of them off by more
than 0.1·lr. A replay of sequential single-item steps amplifies such
flips: Adam's m/√v is ill-conditioned wherever successive gradients
cancel, so two float32 replays of 12 steps from the same inputs differ by
more than 0.1·lr in ~90 % of the parameters (1.3e-3 at most), where in
float64 they agree to 3e-12. So the replay's steps are held in float64
from the same inputs, and in the float32 training iteration its inputs
are held to JAX's and each parameter within 2.5·lr a step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meta_interpolation_tpu.core import adversarial as jadv
from meta_interpolation_tpu_torch.config import get_args
from meta_interpolation_tpu_torch.core import adversarial as adv
from meta_interpolation_tpu_torch.core import checkpoint as bridge
from meta_interpolation_tpu_torch.core import losses
from meta_interpolation_tpu_torch.main import main
from meta_interpolation_tpu_torch.meta.system import (
    SceneAdaptiveInterpolation)

RTOL = 1e-5
INPUT_GRAD_RTOL = 1e-4
STEP_FLIP_SHARE = 1e-3
TYPES = ["GAN", "WGAN", "WGAN_GP"]
CROP = 32

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def nhwc(x):
    return np.ascontiguousarray(np.asarray(x).transpose(0, 2, 3, 1))


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x).transpose(0, 3, 1, 2)))


def jax_disc(patch, seed=0):
    params = jadv.init_discriminator(jax.random.PRNGKey(seed), patch)
    return params, bridge.disc_params_from_jax(jax.tree.map(np.asarray,
                                                            params))


def close(got, want, what, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max() + 1e-12, (what, err)


@pytest.mark.parametrize("patch,hw", [(32, (32, 32)), (32, (40, 52)),
                                      (32, (20, 36)), (96, (96, 96))])
def test_discriminator_matches_jax(patch, hw):
    """The logits at the patch itself, a larger input (center crop) and a
    thinner one (zero pad at the bottom and right, then the crop)."""
    jp, tp = jax_disc(patch)
    x = np.random.RandomState(1).rand(2, *hw, 3).astype(np.float32)
    want = jadv.discriminator_apply(jp, jnp.asarray(x), patch)
    got = adv.discriminator_apply(tp, nchw(x), patch)
    assert got.shape == (2, 1)
    close(got, want, (patch, hw))
    assert adv.feature_patch(patch) ** 2 * 512 == tp[
        "classifier.0.weight"].shape[1]


@pytest.mark.parametrize("gan_type", TYPES)
def test_generator_loss_and_its_input_gradient_match_jax(gan_type):
    jp, tp = jax_disc(CROP)
    x = np.random.RandomState(2).rand(1, CROP, CROP, 3).astype(np.float32)
    want, want_g = jax.value_and_grad(
        lambda v: jadv.generator_loss(jp, v, gan_type, CROP))(jnp.asarray(x))
    xt = nchw(x).requires_grad_(True)
    fn = losses.make_loss_fn(f"1*L1+0.5*{gan_type}", patch_size=CROP)
    out = fn(xt, torch.zeros_like(xt), ctx={"disc": tp})
    got, = torch.autograd.grad(out[gan_type], xt)
    close(float(out[gan_type]), 0.5 * float(want), gan_type)
    want_g = 0.5 * np.asarray(want_g)
    err = np.linalg.norm(nhwc(got.numpy()) - want_g)
    assert err <= INPUT_GRAD_RTOL * np.linalg.norm(want_g), (gan_type, err)
    with pytest.raises(ValueError, match="ctx"):
        fn(xt, xt)


def jax_eps(rng, n):
    """What JAX's WGAN-GP update draws from ``rng``."""
    return np.asarray(jax.random.uniform(rng, (n, 1, 1, 1))).reshape(n)


def hold_steps(got, want, lr, what, steps=1):
    """A discriminator's parameters after ``steps`` sequential steps
    against JAX's (see the module docstring): the flip share after one
    step only."""
    flips = total = 0
    for name, w in want.items():
        diff = (got[name] - w).abs()
        assert float(diff.max()) <= 2.5 * lr * steps, (what, name,
                                                       float(diff.max()))
        flips += int((diff > 0.1 * lr).sum())
        total += diff.numel()
    assert steps > 1 or flips <= STEP_FLIP_SHARE * total, (what, flips,
                                                          total)


@pytest.mark.parametrize("gan_type", TYPES)
def test_discriminator_updates_match_jax(gan_type):
    """Two updates on a batch of two (Adam's moments carry over), WGAN-GP's
    weights handed across; WGAN's clamp holds a parameter pushed past 1 to
    1, on both sides."""
    rs = np.random.RandomState(3)
    fake = rs.rand(2, CROP, CROP, 3).astype(np.float32)
    real = rs.rand(2, CROP, CROP, 3).astype(np.float32)
    jstate = jadv.AdversarialState.create(jax.random.PRNGKey(5), gan_type,
                                          patch_size=CROP)
    if gan_type == "WGAN":
        jstate.params["features"]["0"]["bn"]["scale"] = jnp.full((64,), 1.5)
    state = adv.AdversarialState(gan_type, CROP)
    with torch.no_grad():
        for k, v in bridge.disc_params_from_jax(
                jax.tree.map(np.asarray, jstate.params)).items():
            state.params[k].copy_(v)
    for step in range(2):
        rng = jax.random.PRNGKey(10 + step)
        want = jstate.update_discriminator(jnp.asarray(fake),
                                           jnp.asarray(real), rng)
        got = state.update_discriminator(
            nchw(fake), nchw(real), torch.from_numpy(jax_eps(rng, 2)))
        close(float(got), float(want), (gan_type, step), rtol=1e-4)
    want = bridge.disc_params_from_jax(jax.tree.map(np.asarray,
                                                    jstate.params))
    lr = state.opt.param_groups[0]["lr"]
    hold_steps(state.params, want, lr, gan_type)
    assert state.opt.param_groups[0]["betas"] == (
        (0.0, 0.9) if gan_type == "WGAN_GP" else (0.9, 0.99))
    if gan_type == "WGAN":
        assert float(state.params["features.0.bn.weight"].max()) == 1.0
        assert max(float(p.abs().max()) for p in state.params.values()) \
            <= 1.0


@pytest.mark.parametrize("steps,msl", [(2, True), (3, True), (2, False),
                                       (1, False)])
def test_replay_sequence_matches_jax(steps, msl):
    """The --disc_per_forward order: MSL's query predictions of steps
    0..n−2 after each step's pairs; without MSL (and in the one-step case,
    whose only query call is the final one) the pairs then the final
    query."""
    b, p, t = 2, 2, 7
    rs = np.random.RandomState(4)
    sp = rs.rand(b, steps, p, 4, 5, 3).astype(np.float32)
    qp = (rs.rand(b, steps - 1, 4, 5, 3).astype(np.float32)
          if msl and steps > 1 else None)
    final = rs.rand(b, 4, 5, 3).astype(np.float32)
    frames = rs.rand(b, t, 4, 5, 3).astype(np.float32)
    want_f, want_r = jadv.build_replay_sequence(
        jnp.asarray(sp), None if qp is None else jnp.asarray(qp),
        jnp.asarray(final), jnp.asarray(frames), [2, 4], 3)
    to_t = lambda a: torch.from_numpy(np.moveaxis(a, -1, -3).copy())
    got_f, got_r = adv.build_replay_sequence(
        to_t(sp), None if qp is None else to_t(qp), to_t(final),
        to_t(frames), [2, 4], 3)
    n = b * (steps * p + (0 if qp is None else steps - 1) + 1)
    assert got_f.shape == (n, 1, 3, 4, 5) == got_r.shape
    np.testing.assert_array_equal(np.moveaxis(got_f.numpy(), 2, -1),
                                  np.asarray(want_f))
    np.testing.assert_array_equal(np.moveaxis(got_r.numpy(), 2, -1),
                                  np.asarray(want_r))


@pytest.mark.parametrize("gan_type", TYPES)
def test_replay_updates_match_jax_in_float64(gan_type):
    """12 sequential single-item updates from the same fakes and reals (and
    WGAN-GP weights), float64 on both sides: JAX's on-device scan
    (``jitted_sequential_update``) against the port's replay."""
    n = 12
    rs = np.random.RandomState(6)
    fakes = rs.rand(n, 1, CROP, CROP, 3)
    reals = rs.rand(n, 1, CROP, CROP, 3)
    keys = jax.random.split(jax.random.PRNGKey(7), n)
    jax.config.update("jax_enable_x64", True)
    try:
        jstate = jadv.AdversarialState.create(jax.random.PRNGKey(5),
                                              gan_type, patch_size=CROP)
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                              jstate.params)
        params, _, jlosses = jstate.jitted_sequential_update()(
            params, jstate.tx.init(params), jnp.asarray(fakes),
            jnp.asarray(reals), keys)
        want = bridge.disc_params_from_jax(jax.tree.map(np.asarray,
                                                        params))
        eps = np.concatenate([np.asarray(jax.random.uniform(
            k, (1, 1, 1, 1), jnp.float64)).reshape(1) for k in keys])
        init = bridge.disc_params_from_jax(jax.tree.map(np.asarray,
                                                        jstate.params))
    finally:
        jax.config.update("jax_enable_x64", False)
    state = adv.AdversarialState(gan_type, CROP)
    state.disc.double()
    state.params = {k: p.detach() for k, p in state.disc.named_parameters()}
    state.opt = state.make_optimizer()
    with torch.no_grad():
        for k, v in init.items():
            state.params[k].copy_(v)
    to_t = lambda a: torch.from_numpy(np.moveaxis(a, -1, 2).copy())
    losses = state.replay(to_t(fakes), to_t(reals),
                          torch.from_numpy(eps) if gan_type == "WGAN_GP"
                          else None)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                               rtol=1e-9)
    for k, w in want.items():
        torch.testing.assert_close(state.params[k], w, rtol=0, atol=1e-9)


def test_cli_trains_with_a_gan_term_on_the_cpu(tmp_path, capsys):
    """The training CLI with a GAN term in each cadence; the checkpoint
    carries the discriminator, which --resume loads back. Without a card,
    --device cuda raises."""
    for extra in ([], ["--disc_per_forward"]):
        argv = ["--model", "voxelflow", "--mode", "train", "--dataset",
                "synthetic", "--crop_size", str(CROP), "--batch_size", "1",
                "--optimizer", "Adam", "--metasgd", "--loss",
                "1*MSE+0.005*WGAN_GP", "--inner_lr", "1e-5", "--outer_lr",
                "1e-5", "--number_of_training_steps_per_iter", "1",
                "--number_of_evaluation_steps_per_iter", "1",
                "--fast_warp_range", "4", "--max_epoch", "1",
                "--total_iter_per_epoch", "2", "--checkpoint_dir",
                str(tmp_path), *extra]
        stats = main(argv + ["--device", "cpu"])
        out = capsys.readouterr().out
        assert "[epoch 0 it 0] loss" in out and "[val epoch 0]" in out
        assert np.isfinite(stats["best_psnr"])
        state = bridge.load_checkpoint(str(tmp_path / "exp"))
        disc = state["system"]["meta_params"]["loss_ctx"]
        resumed = SceneAdaptiveInterpolation(get_args(argv + ["--device",
                                                                "cpu"]))
        resumed.load_state_dict(state["system"])
        for k, v in disc.items():
            assert torch.equal(resumed.adv_state.params[k], v), k
    for path in tmp_path.rglob("*.pth"):   # weights read: free the disk
        path.unlink()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv + ["--device", "cuda"])
