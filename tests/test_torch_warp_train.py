"""The port's meta-training of the warp models held against the JAX system
on the CPU: VoxelFlow here (run_voxelflow.sh: Adam, Meta-SGD, 1*MSE, one
inner step), with its outer Adam policy groups, the plateau schedule and
``--resume``; this file's helpers serve the RRIN, SuperSloMo and DAIN
files (tests/test_torch_{rrin,superslomo,dain}_train*.py).

Each test builds a JAX system and a port system with the JAX init and
Meta-SGD rates bridged into the port. The JAX outer loss and gradient are
``jax.value_and_grad`` of its training task episode, op by op (the bounded
warp's unrolled (2R + 2)² sweep makes the whole episode compile for
minutes under ``jax.jit``), but for the sweep itself, compiled on its own
(``jitted_sweep``).
First order runs at the preset's inner rule; second order at the inner SGD
rule, whose second derivative is smooth (the first inner Adam step is
~lr·sign(g), whose derivative eps/(|g| + eps)² reaches 1e8 at g ≈ 0, so no
two float32 evaluations hold it). Limits as PERF.md §2: the outer loss to
1e-5, each tensor's gradient within 1e-3 of its norm. After an inner Adam
or Adamax step each parameter group's gradient is held within 1e-3 in
norm instead, as chip_smoke.py holds the card to the CPU: the step is
~lr·sign(g), so an element whose support gradient is within rounding of
zero steps the other way on one side, which moves a small tensor's query
gradient by more (SuperSloMo's flowComp.up1.conv1.bias by 1.4e-2 of its
norm, its group by 1.3e-4; at the inner SGD rule every tensor within 7e-5).
"""
import contextlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from meta_interpolation_tpu.config import Config as JaxConfig
from meta_interpolation_tpu.meta import episode as jax_episode
from meta_interpolation_tpu.meta.system import (
    SceneAdaptiveInterpolation as JaxSystem)
from meta_interpolation_tpu.ops import warp as jax_warp
from meta_interpolation_tpu_torch.config import Config
from meta_interpolation_tpu_torch.core import checkpoint as bridge
from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
from meta_interpolation_tpu_torch.meta.system import (
    SceneAdaptiveInterpolation)
from meta_interpolation_tpu_torch.ops import warp_bounded as wb

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-12
CROP = 32
R = 4
PRESETS = {
    "rrin": dict(model="rrin", loss="1*L1", optimizer="Adam",
                 number_of_training_steps_per_iter=0),
    "superslomo": dict(model="superslomo", loss="1*Super", optimizer="Adam",
                       metasgd=True, number_of_training_steps_per_iter=1),
    "voxelflow": dict(model="voxelflow", loss="1*MSE", optimizer="Adam",
                      metasgd=True, number_of_training_steps_per_iter=1),
}
KERNELS = ("warp_sample_bounded_forward", "warp_sample_bounded_grad_grid",
           "warp_sample_bounded_grad_grid_backward")

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def config(model, order, warp_range, **extra):
    """The preset in training at CROP, first order at its own inner rule or
    second order at the inner SGD rule with one inner step."""
    cfg = dict(PRESETS[model], inner_lr=1e-5, outer_lr=1e-5,
               number_of_evaluation_steps_per_iter=1, crop_size=CROP,
               mode="train", fast_warp_range=warp_range, batch_size=1)
    if order == "second":
        cfg.update(optimizer="SGD", second_order=True,
                   number_of_training_steps_per_iter=1)
    cfg.update(extra)
    return cfg


def groups(tsys):
    """The meta-parameter groups the two systems share: the net, and the
    inner rates under Meta-SGD (LSLR's fixed rates are a (steps + 1,)
    vector a tensor, the same on both sides and never trained)."""
    return ("net", "lrs") if tsys.cfg.metasgd else ("net",)


def from_jax(tree, tsys, group):
    """A JAX tree of one group → the port's tensors of that group (BN
    statistics, buffers in the port, left out)."""
    return {k: v for k, v in bridge.params_from_jax(tree, tsys.model).items()
            if k in tsys.meta_params[group]}


def bridge_meta(jsys, tsys):
    """The JAX meta-parameters (net with its BN statistics, and the
    Meta-SGD rates) into the port's, and the JAX Super loss's VGG16
    weights where it has one."""
    tree = jax.tree.map(np.asarray, jsys.meta_params)
    tsys.load_net(bridge.params_from_jax(tree["net"], tsys.model))
    if tsys.cfg.metasgd:
        with torch.no_grad():
            for name, value in from_jax(tree["lrs"], tsys, "lrs").items():
                tsys.meta_params["lrs"][name].copy_(value)
    vgg = inspect.getclosurevars(jsys.loss_fn).nonlocals.get("vgg16_params")
    if vgg is not None:
        tsys.loss_fn.vgg16_params = bridge.vgg16_params_from_jax(
            jax.tree.map(np.asarray, vgg))


def systems(cfg):
    jsys = JaxSystem(JaxConfig(**cfg, jit_episode=False))
    tsys = SceneAdaptiveInterpolation(Config(**cfg, device="cpu"))
    bridge_meta(jsys, tsys)
    return jsys, tsys


def clips(model, n, crop=CROP):
    data = SyntheticSeptuplet(model=model, mode="train", size=(crop, crop))
    return np.stack([np.asarray(data[i][0]) for i in range(n)])


@contextlib.contextmanager
def jitted_sweep(jsys):
    """Where ``jsys`` runs the bounded warp, its sweep (``ops/warp.py``
    ``_warp_bounded_xla``, which an episode runs on the CPU) compiled on
    its own while the block runs: one XLA program a shape and R in place
    of the ops of its (2R + 2)² shifted windows dispatched one at a time,
    the rest of an op-by-op episode as it was. The same function: the
    reference is unchanged."""
    real = jax_warp._warp_bounded_xla
    if jsys.cfg.fast_warp_range:
        jax_warp._warp_bounded_xla = jax.jit(real, static_argnums=5)
    try:
        yield
    finally:
        jax_warp._warp_bounded_xla = real


def jax_outer(jsys, frames, jit=False):
    """The JAX outer loss and masked gradient: ``jax.value_and_grad`` of
    its training task episode on each task, averaged (its vmap and mean),
    op by op or, with ``jit`` (a model without the bounded warp), as one
    compiled program."""
    cfg = jsys.cfg
    spec = jsys._episode_spec("train", cfg.num_inner_steps,
                              jsys._use_second_order(0), jsys._msl_active(0))
    msl_w = jnp.asarray(jax_episode.per_step_loss_importance(
        cfg.num_inner_steps, 0, cfg.multi_step_loss_num_epochs))

    def outer(mp, task):
        return jsys.builder.task_episode(mp, task, msl_w, spec,
                                         training=True)[0]

    step = jax.value_and_grad(outer)
    step = jax.jit(step) if jit else step
    with jitted_sweep(jsys):
        runs = [step(jsys.meta_params, jnp.asarray(task))
                for task in frames]
    grads = jax.tree.map(lambda *g: sum(g) / len(g), *[g for _, g in runs])
    grads = jax.tree.map(lambda g, m: g * float(m), grads,
                         jsys._trainable_mask)
    return float(sum(o for o, _ in runs) / len(runs)), grads


def hold_outer_to_jax(jsys, tsys, frames, jit=False):
    """The port's outer loss and gradient against JAX's (``jax_outer``):
    each trainable tensor's, or each group's after an inner Adam or Adamax
    step (see above); returns the port's gradients."""
    want_loss, want = jax_outer(jsys, frames, jit)
    loss, aux, got = tsys.outer_grads(frames, 0)
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    assert aux["preds"].shape == (len(frames), 3) + frames.shape[2:4]
    want = jax.tree.map(np.asarray, want)
    per_tensor = (tsys.cfg.optimizer == "SGD"
                  or tsys.cfg.num_inner_steps == 0)
    for group in groups(tsys):
        pairs = [(name, got[group][name], w) for name, w in
                 from_jax(want[group], tsys, group).items()]
        if not per_tensor:
            pairs = [(group, torch.cat([g.flatten() for _, g, _ in pairs]),
                      torch.cat([w.flatten() for _, _, w in pairs]))]
        for name, g, w in pairs:
            err = float((g - w).norm())
            assert err <= GRAD_RTOL * float(w.norm()) + GRAD_ATOL, (
                group, name, err, float(w.norm()))
        assert any(float(w.norm()) > 0 for _, _, w in pairs), group
    return got


@pytest.mark.parametrize("order,warp_range", [
    ("first", R), ("second", R), ("first", 0), ("second", 0)])
def test_voxelflow_outer_loss_and_gradient_match_jax(order, warp_range):
    jsys, tsys = systems(config("voxelflow", order, warp_range))
    got = hold_outer_to_jax(jsys, tsys, clips("voxelflow", 1))
    # the BN affine trains in the outer loop (inner-frozen: a second-order
    # cross term only), the statistics are buffers
    assert float(got["net"]["conv1_bn.weight"].norm()) > 0
    assert "conv1_bn.running_mean" not in got["net"]


def _jax_update(jsys, grads):
    """JAX train_step's update: masked gradients through its outer
    transform, masked updates applied."""
    mask = jax.tree.map(lambda b: jnp.asarray(b, jnp.float32),
                        jsys._trainable_mask)
    grads = jax.tree.map(lambda g, m: g * m, grads, mask)
    updates, jsys.opt_state = jsys.tx.update(grads, jsys.opt_state,
                                             jsys.meta_params)
    updates = jax.tree.map(lambda u, m: u * m, updates, mask)
    jsys.meta_params = optax.apply_updates(jsys.meta_params, updates)


def _port_update(tsys, grads):
    """run_train_iter's update with the given gradients."""
    for g, tree in tsys.meta_params.items():
        for k, v in tree.items():
            v.grad = grads[g][k].clone() if tsys.trainable[g][k] else None
    tsys.outer_opt.step()
    tsys.outer_opt.zero_grad(set_to_none=True)


def test_voxelflow_outer_adam_groups_match_optax():
    """The outer Adam policy groups (conv weights at the rate with decay,
    conv biases at twice the rate without, BN scale and bias with decay,
    the Meta-SGD rates plain) against the JAX package's optax ``vf_adam``:
    two updates, a plateau decay of the rate, a third update; each group
    keeps its multiplier through the decay."""
    # decay 1 on gradients of ~1e-2: the decay moves each step visibly
    cfg = config("voxelflow", "first", 0, outer_lr=1e-3, weight_decay=1.0)
    jsys, tsys = systems(cfg)
    assert [g["name"] for g in tsys.outer_opt.param_groups] == [
        "conv weights", "conv biases", "bn affine", "inner rates"]
    rs = np.random.RandomState(0)
    for step in range(3):
        if step == 2:
            for val in [1.0] + [2.0] * 6:   # the 6th bad epoch decays
                jsys.epoch_end(val)
                tsys.epoch_end(val)
            assert tsys.scheduler.lr == pytest.approx(2e-4)
            lrs = {g["name"]: g["lr"] for g in tsys.outer_opt.param_groups}
            assert lrs["conv biases"] == pytest.approx(4e-4)
            assert lrs["conv weights"] == pytest.approx(2e-4)
        grads = jax.tree.map(
            lambda p: jnp.asarray(0.01 * rs.randn(*np.shape(p)).astype(
                np.float32)), jsys.meta_params)
        tree = jax.tree.map(np.asarray, grads)
        _jax_update(jsys, grads)
        _port_update(tsys, {g: from_jax(tree[g], tsys, g)
                            for g in ("net", "lrs")})
        want = jax.tree.map(np.asarray, jsys.meta_params)
        for g in ("net", "lrs"):
            for name, w in from_jax(want[g], tsys, g).items():
                # steps of ~lr = 1e-3: rounding within 1e-3 of a step
                torch.testing.assert_close(
                    tsys.meta_params[g][name], w, rtol=0.0, atol=1e-6,
                    msg=f"step {step} {g} {name}")
    assert tsys.outer_opt.param_groups[1]["params"] == [
        tsys.meta_params["net"]["conv4.bias"]]


def test_voxelflow_resume_continues_bit_equal(tmp_path):
    """Two train iterations in one system against one, a checkpoint
    written and read by core/checkpoint.py, and one more in a new system
    resumed from it (after a plateau decay, so each group's rate is
    restored too): the meta-parameters are equal bit for bit."""
    from meta_interpolation_tpu_torch.core import checkpoint as ckpt_lib
    cfg = Config(**config("voxelflow", "first", R), device="cpu")
    frames = clips("voxelflow", 2)
    straight = SceneAdaptiveInterpolation(cfg)
    first = SceneAdaptiveInterpolation(cfg)
    for system in (straight, first):
        system.run_train_iter(frames[:1], 0)
        for val in [1.0] + [2.0] * 6:
            system.epoch_end(val)
    ckpt_lib.save_checkpoint({"system": first.state_dict()}, str(tmp_path))
    resumed = SceneAdaptiveInterpolation(cfg)
    resumed.load_state_dict(ckpt_lib.load_checkpoint(str(tmp_path))["system"])
    assert ([g["lr"] for g in resumed.outer_opt.param_groups]
            == [g["lr"] for g in straight.outer_opt.param_groups])
    for system in (straight, resumed):
        system.run_train_iter(frames[1:], 1)
    for g, tree in straight.meta_params.items():
        for k, v in tree.items():
            assert torch.equal(v, resumed.meta_params[g][k]), (g, k)
    (tmp_path / "checkpoint.pth").unlink()


def counting_wrappers(monkeypatch):
    """Count each warp wrapper's calls on the CPU, where the wrappers run
    their plain versions (a kernel's launch on the card)."""
    counts = dict.fromkeys(KERNELS, 0)
    for name in KERNELS:
        real = getattr(wb, name)

        def counted(*args, _real=real, _name=name, **kwargs):
            counts[_name] += 1
            return _real(*args, **kwargs)
        counted.launches = 0
        monkeypatch.setattr(wb, name, counted)
    return counts


def train_launches(steps, warps, second):
    """What chip_smoke.py derives for one task of n inner steps and w
    warps a forward: (2n + 1)·w K3 and as many K3-grad in first order;
    (2n + 1)·w, (4n + 1)·w and 2n·w K3-grad² in second order."""
    k3 = (2 * steps + 1) * warps
    return {KERNELS[0]: k3, KERNELS[1]: (4 * steps + 1) * warps if second
            else k3, KERNELS[2]: 2 * steps * warps if second else 0}


@pytest.mark.parametrize("model,warps", [("voxelflow", 2), ("rrin", 2)])
@pytest.mark.parametrize("order", ["first", "second"])
def test_train_iteration_calls_each_wrapper_as_derived(model, warps, order,
                                                       monkeypatch):
    counts = counting_wrappers(monkeypatch)
    cfg = config(model, order, R, batch_size=2)
    system = SceneAdaptiveInterpolation(Config(**cfg, device="cpu"))
    system.run_train_iter(clips(model, 2), 0)
    steps = cfg["number_of_training_steps_per_iter"]
    want = {k: 2 * v for k, v in
            train_launches(steps, warps, order == "second").items()}
    assert counts == want
