"""The port's legacy trainers (meta_interpolation_tpu_torch/legacy/) held
against the JAX package's on the CPU: Reptile, first-order MAML and the
evaluation episode on a two-frame convolution with bridged weights, under
inner Adamax and Adam, with and without the DAIN-style mask, the
(pred, aux) models, the presets and flags, and the command line."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from meta_interpolation_tpu.legacy import driver as jax_driver
from meta_interpolation_tpu.legacy import trainers as jax_trainers
from meta_interpolation_tpu_torch.core import checkpoint as bridge
from meta_interpolation_tpu_torch.legacy import driver, trainers

# weights after the steps, and losses: float32 in another summation order
# (a few inner and outer steps of 1e-2 on O(0.1) weights)
PARAM_ATOL, LOSS_RTOL = 1e-6, 1e-5
INNER_LR, OUTER_LR, STEPS = 1e-2, 3e-2, 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class TwoFrameConv(nn.Module):
    """pred = conv3x3(concat(f0, f1)); with ``aux`` also returns the
    difference of the inputs as SuperSloMo returns its intermediates."""

    def __init__(self, aux=False):
        super().__init__()
        self.conv = nn.Conv2d(6, 3, 3, padding=1)
        self.aux = aux

    def forward(self, f0, f1):
        pred = self.conv(torch.cat([f0, f1], 1))
        return (pred, {"diff": f0 - f1}) if self.aux else pred


def _jax_apply(aux):
    def apply(params, f0, f1):
        x = jnp.concatenate([f0, f1], -1)
        pred = jax.lax.conv_general_dilated(
            x, params["conv"]["kernel"], (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            precision=jax.lax.Precision.HIGHEST) + params["conv"]["bias"]
        return (pred, {"diff": f0 - f1}) if aux else pred
    return apply


def _jax_loss(pred, target, aux=None):
    val = jnp.mean(jnp.abs(pred - target))
    if aux is not None:
        val = val + 0.1 * jnp.mean(jnp.abs(aux["diff"] - aux["I0"]
                                           + aux["I1"]))
        val = val + 0.01 * jnp.mean(aux["I0"])
    return val


def _port_loss(pred, target, aux=None):
    val = torch.mean(torch.abs(pred - target))
    if aux is not None:
        val = val + 0.1 * torch.mean(torch.abs(aux["diff"] - aux["I0"]
                                               + aux["I1"]))
        val = val + 0.01 * torch.mean(aux["I0"])
    return val


@pytest.fixture
def setup():
    rs = np.random.RandomState(0)
    frames = rs.rand(2, 7, 8, 8, 3).astype(np.float32)
    jparams = {"conv": {"kernel": (0.1 * rs.randn(3, 3, 6, 3)).astype(
        np.float32), "bias": (0.1 * rs.randn(3)).astype(np.float32)}}
    return frames, jparams


def _port(jparams, aux=False):
    model = TwoFrameConv(aux)
    model.requires_grad_(False)
    params = bridge.params_from_jax(jparams, model)
    return model, {k: v.clone() for k, v in params.items()}


def _close(port_params, jparams, model):
    want = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), model)
    for k, v in want.items():
        np.testing.assert_allclose(port_params[k].numpy(), v.numpy(),
                                   atol=PARAM_ATOL, err_msg=k)


def _t(frames):
    return driver.to_device_frames(frames, "cpu")


MASKS = {"none": None, "weight_only": {"conv.weight": True,
                                       "conv.bias": False}}


def _jax_mask(mask):
    if mask is None:
        return None
    return {"conv": {"kernel": jnp.asarray(float(mask["conv.weight"])),
                     "bias": jnp.asarray(float(mask["conv.bias"]))}}


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("rule", ["Adamax", "Adam"])
def test_reptile_step_matches_jax(setup, rule, mask):
    frames, jparams = setup
    model, params = _port(jparams)
    want, want_q = jax_trainers.reptile_step(
        _jax_apply(False), _jax_loss, jax.tree.map(jnp.asarray, jparams),
        jnp.asarray(frames), INNER_LR, OUTER_LR, num_steps=STEPS,
        inner_rule=rule, mask=_jax_mask(MASKS[mask]))
    got, q = trainers.reptile_step(model, _port_loss, params, _t(frames),
                                   INNER_LR, OUTER_LR, num_steps=STEPS,
                                   inner_rule=rule, mask=MASKS[mask])
    _close(got, want, model)
    np.testing.assert_allclose(float(q), float(want_q), rtol=LOSS_RTOL)
    if mask != "none":
        assert torch.equal(got["conv.bias"], params["conv.bias"])
    assert not torch.equal(got["conv.weight"], params["conv.weight"])


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("rule", ["Adamax", "Adam"])
def test_fomaml_step_matches_jax(setup, rule, mask):
    """Two steps, so the outer optimizer's moments carry over: the port's
    torch optimizer with optax's defaults against optax's."""
    frames, jparams = setup
    model, params = _port(jparams)
    tx = {"Adamax": optax.adamax, "Adam": optax.adam}[rule](OUTER_LR)
    jp = jax.tree.map(jnp.asarray, jparams)
    state = tx.init(jp)
    opt = driver.make_outer_optimizer(rule, params.values(), OUTER_LR)
    bias0 = params["conv.bias"].clone()
    for seed in (0, 1):
        batch = np.roll(frames, seed, axis=1)
        jp, state, want_loss = jax_trainers.fomaml_step(
            _jax_apply(False), _jax_loss, jp, state, tx, jnp.asarray(batch),
            INNER_LR, num_steps=STEPS, inner_rule=rule,
            mask=_jax_mask(MASKS[mask]))
        params, loss = trainers.fomaml_step(
            model, _port_loss, params, opt, _t(batch), INNER_LR,
            num_steps=STEPS, inner_rule=rule, mask=MASKS[mask])
        np.testing.assert_allclose(float(loss), float(want_loss),
                                   rtol=LOSS_RTOL)
        _close(params, jp, model)
    if mask != "none":
        assert torch.equal(params["conv.bias"], bias0)
        assert params["conv.bias"] not in opt.state


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("rule", ["Adamax", "Adam"])
def test_eval_episode_matches_jax(setup, rule, mask):
    frames, jparams = setup
    model, params = _port(jparams)
    before = {k: v.clone() for k, v in params.items()}
    want_loss, want_pred = jax_trainers.eval_episode(
        _jax_apply(False), _jax_loss, jax.tree.map(jnp.asarray, jparams),
        jnp.asarray(frames), INNER_LR, STEPS, inner_rule=rule,
        mask=_jax_mask(MASKS[mask]))
    loss, pred = trainers.eval_episode(model, _port_loss, params,
                                       _t(frames), INNER_LR, STEPS,
                                       inner_rule=rule, mask=MASKS[mask])
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(pred.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want_pred), atol=PARAM_ATOL)
    for k, v in before.items():     # the adapted copy is thrown away
        assert torch.equal(params[k], v)


def test_models_with_aux_get_their_inputs(setup):
    """A (pred, aux) model's loss reads aux with I0/I1 added, in every
    forward of the step (SuperSloMo's Super loss)."""
    frames, jparams = setup
    model, params = _port(jparams, aux=True)
    want, want_q = jax_trainers.reptile_step(
        _jax_apply(True), _jax_loss, jax.tree.map(jnp.asarray, jparams),
        jnp.asarray(frames), INNER_LR, OUTER_LR, num_steps=1)
    got, q = trainers.reptile_step(model, _port_loss, params, _t(frames),
                                   INNER_LR, OUTER_LR, num_steps=1)
    _close(got, want, model)
    np.testing.assert_allclose(float(q), float(want_q), rtol=LOSS_RTOL)


def test_presets_and_flags_match_jax():
    from meta_interpolation_tpu.legacy import (
        train_dain as jd, train_sepconv as js, train_superslomo as jss,
        train_voxelflow as jv)
    from meta_interpolation_tpu_torch.legacy import (
        train_dain, train_sepconv, train_superslomo, train_voxelflow)
    for mine, theirs in ((train_sepconv, js), (train_voxelflow, jv),
                         (train_superslomo, jss), (train_dain, jd)):
        assert (dataclasses.asdict(mine.PRESET)
                == dataclasses.asdict(theirs.PRESET))
        ours = vars(driver.parse_args(mine.PRESET, []))
        assert ours.pop("device") == "cuda"
        assert ours == vars(jax_driver.parse_args(theirs.PRESET, []))
    assert driver.parse_args(train_sepconv.PRESET,
                             ["--bs", "3"]).batch_size == 3


def _cli(main, tmp_path, *extra):
    return main(["--dataset", "synthetic", "--crop_size", "32",
                 "--batch_size", "1", "--val_batch_size", "1",
                 "--max_epoch", "1", "--train_iter", "2", "--val_iter", "1",
                 "--logfreq", "1", "--num_inner_update", "1",
                 "--checkpoint_dir", str(tmp_path), "--device", "cpu",
                 *extra])


def test_cli_voxelflow_maml_epoch(tmp_path, capsys):
    from meta_interpolation_tpu_torch.legacy import train_voxelflow
    params = _cli(train_voxelflow.main, tmp_path, "--exp_name", "vf")
    out = capsys.readouterr().out
    assert "Epoch: [0][0]" in out and "Epoch: [0][1]" in out
    assert "val_PSNR:" in out
    state = bridge.load_checkpoint(str(tmp_path / "vf"))
    try:
        assert state["epoch"] == 1 and np.isfinite(state["best_PSNR"])
        assert state["arch"]["meta_algorithm"] == "maml"
        for k, v in params.items():
            assert torch.equal(state["params"][k], v)
    finally:
        for path in tmp_path.rglob("*.pth"):
            path.unlink()


def test_cli_reptile_validates_only_in_test_mode(tmp_path, capsys):
    from meta_interpolation_tpu_torch.legacy import train_voxelflow
    _cli(train_voxelflow.main, tmp_path, "--meta_algorithm", "reptile",
         "--mode", "test", "--exp_name", "rep")
    out = capsys.readouterr().out
    assert "val_PSNR:" in out and "Epoch:" not in out
    assert not list(tmp_path.rglob("*.pth"))


def test_sepconv_steps_launch_what_chip_smoke_holds(monkeypatch):
    """SepConv's K1 and K2 calls (their plain versions on the CPU, counted)
    in one MAML step, one Reptile step and one evaluation episode of 1
    inner step: chip_smoke.py's LEGACY_LAUNCHES."""
    import chip_smoke
    from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
    from meta_interpolation_tpu_torch.legacy import train_sepconv
    from meta_interpolation_tpu_torch.ops import sepconv as sc
    calls = {"sepconv_forward": 0, "sepconv_grad_kernels": 0}
    for name, ref in (("sepconv_forward", "sepconv_ref"),
                      ("sepconv_grad_kernels", "grad_kernels_ref")):
        real = getattr(sc, ref)

        def counted(*a, _name=name, _real=real):
            calls[_name] += 1
            return _real(*a)
        monkeypatch.setattr(sc, ref, counted)
    preset = train_sepconv.PRESET
    cfg = driver.parse_args(preset, ["--device", "cpu"])
    _, model, params, loss_fn, mask, _ = driver.build(preset, cfg)
    opt = driver.make_outer_optimizer(preset.outer_opt, params.values(), 1e-5)
    frames = _t(np.asarray(SyntheticSeptuplet(mode="train", size=(16, 16))[
        0][0])[None])
    kw = dict(num_steps=chip_smoke.LEGACY_STEPS, inner_rule="Adamax")
    for algo, step in (
            ("maml", lambda: trainers.fomaml_step(model, loss_fn, params,
                                                  opt, frames, 1e-5, **kw)),
            ("reptile", lambda: trainers.reptile_step(
                model, loss_fn, params, frames, 1e-5, 1e-5, **kw)),
            ("eval", lambda: trainers.eval_episode(model, loss_fn, params,
                                                   frames, 1e-5, **kw))):
        calls.update(sepconv_forward=0, sepconv_grad_kernels=0)
        step()
        assert calls == chip_smoke.LEGACY_LAUNCHES[algo], algo
