"""The port's meta-training (meta_interpolation_tpu_torch/meta/) held
against the JAX package on the CPU: the first-order outer loss and
gradient with Meta-SGD, one outer update, the outer optimizers against
optax, the plateau schedule, the checkpointed state and ``--fix_loaded``;
and, on a two-conv model small enough to compile in seconds, the episode
itself over 3 inner steps with MSL, first and second order.

One JAX SepConv system and one port system, with the JAX init bridged into
the port, are shared by this file: crop 32 (padded to 128×128 by the
model), batch 2, Adamax, Meta-SGD, MSL on, 1 inner step (each more
inner step adds ~50 s to the JAX program's trace and compile on an
8-core CPU; the tiny model carries the multi-step cases).
"""
import copy
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from meta_interpolation_tpu.config import Config as JaxConfig
from meta_interpolation_tpu.core import checkpoint as jax_ckpt
from meta_interpolation_tpu.meta import episode as jax_episode
from meta_interpolation_tpu.meta import system as jax_system
from meta_interpolation_tpu_torch.config import Config
from meta_interpolation_tpu_torch.core import checkpoint as bridge
from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
from meta_interpolation_tpu_torch.meta import system

LR = 1e-5
CFG = dict(model="sepconv", optimizer="Adamax", metasgd=True, inner_lr=LR,
           outer_lr=LR, crop_size=32, batch_size=2, mode="train",
           number_of_training_steps_per_iter=1,
           use_multi_step_loss_optimization=True, loss="1*L1")
LOSS_RTOL = 1e-5
# per-leaf ‖g_port − g_jax‖ ≤ GRAD_RTOL·‖g_jax‖ + GRAD_ATOL. Only the
# summation order differs, but an inner Adamax step is ~lr·sign(g), so an
# element whose support gradient is within rounding of zero may step the
# other way and move the outer gradient a little (see STEP_* below).
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-12
# the Adamax flip allowance of tests/test_torch_episode.py: an outer step
# is ~lr·sign(g) too
STEP_ATOL = 0.1 * LR
STEP_FLIP_SHARE = 1e-5
# float32 updates, 3 steps of them, in another order
OPT_RTOL, OPT_ATOL = 1e-5, 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's PyTorch work: the tier-1 run
    puts six test processes on the machine's cores, where every process
    taking a thread a core oversubscribes them many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _names(tree, prefix=""):
    """A JAX net tree (or a mask like it) → {port name: leaf}."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_names(value, f"{prefix}{key}."))
        else:
            out[prefix + ("weight" if key == "kernel" else key)] = value
    return out


def _jax_grads_as_port(grads, tsys):
    """JAX meta-gradients → {'net': port layout, 'lrs': port layout}."""
    np_tree = jax.tree.map(np.asarray, grads)
    return {group: bridge.params_from_jax(np_tree[group], tsys.model)
            for group in ("net", "lrs")}


def _bridge_meta(jsys, tsys):
    """The JAX meta-parameters (net and Meta-SGD rates) into the port's own
    tensors, which its outer optimizer holds."""
    np_tree = jax.tree.map(np.asarray, jsys.meta_params)
    with torch.no_grad():
        for group in ("net", "lrs"):
            for name, value in bridge.params_from_jax(np_tree[group],
                                                      tsys.model).items():
                tsys.meta_params[group][name].copy_(value)


@pytest.fixture(scope="module")
def systems():
    jsys = jax_system.SceneAdaptiveInterpolation(JaxConfig(**CFG))
    tsys = system.SceneAdaptiveInterpolation(Config(**CFG, device="cpu"))
    _bridge_meta(jsys, tsys)
    data = SyntheticSeptuplet(model="sepconv", mode="train", size=(32, 32))
    frames = np.stack([np.asarray(data[i][0]) for i in range(2)])
    return jsys, tsys, frames


@pytest.fixture(scope="module")
def jax_outer(systems):
    """The JAX outer loss, query loss and masked gradient: jax.value_and_grad
    of its training task episode, one jitted program run on each task and
    averaged, which is what its batched episode's vmap and mean compute
    (the vmapped program takes ~3x as long to trace, compile and run on
    an 8-core CPU)."""
    jsys, _, frames = systems
    spec = jsys._episode_spec("train", 1, jsys._use_second_order(0),
                              jsys._msl_active(0))
    msl_w = jnp.asarray(jax_episode.per_step_loss_importance(1, 0, 1))

    def outer(mp, task):
        o, _, q = jsys.builder.task_episode(mp, task, msl_w, spec,
                                            training=True)
        return o, q

    step = jax.jit(jax.value_and_grad(outer, has_aux=True))
    runs = [step(jsys.meta_params, jnp.asarray(task)) for task in frames]
    mean = lambda *xs: sum(xs) / len(xs)
    grads = jax.tree.map(mean, *[g for _, g in runs])
    grads = jax.tree.map(lambda g, m: g * float(m), grads,
                         jsys._trainable_mask)
    return (float(mean(*[o for (o, _), _ in runs])),
            float(mean(*[q for (_, q), _ in runs])), grads)


@pytest.fixture(scope="module")
def port_step(systems):
    """One run_train_iter of the port system, with the outer gradient it
    took recorded; the system's state is restored after."""
    _, tsys, frames = systems
    saved = copy.deepcopy(tsys.state_dict())
    taken = []
    real = tsys.outer_grads
    tsys.outer_grads = lambda *a, **k: taken.append(real(*a, **k)) or taken[0]
    try:
        losses, preds = tsys.run_train_iter(frames, 0, do_evaluation=True)
    finally:
        del tsys.outer_grads
    after = copy.deepcopy(tsys.meta_params)
    tsys.load_state_dict(saved)
    return losses, preds, taken[0], saved["meta_params"], after


def test_outer_loss_and_gradient_match_jax(systems, jax_outer, port_step):
    _, tsys, _ = systems
    want_loss, _, want = jax_outer
    loss, aux, got = port_step[2]
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    assert aux["preds"].shape == (2, 3, 32, 32)
    want = _jax_grads_as_port(want, tsys)
    for group in ("net", "lrs"):
        for name, w in want[group].items():
            g = got[group][name]
            err = float((g - w).norm())
            lim = GRAD_RTOL * float(w.norm()) + GRAD_ATOL
            assert err <= lim, (group, name, err, float(w.norm()))
            if name.startswith("moduleVertical") and group == "lrs":
                # an inner-frozen tensor's rate never acts
                assert float(w.abs().max()) == 0.0
                assert float(g.abs().max()) == 0.0
    # the gradient is not trivially small: the encoder's rates learn
    assert float(got["lrs"]["moduleConv1.0.weight"].norm()) > 0


def test_run_train_iter_matches_jax(systems, jax_outer, port_step):
    """The port's run_train_iter against the JAX train step's update of
    the same gradient: mask, optax update, mask, apply (JAX
    meta/system.py:449-473, here outside jit: jitting the JAX step would
    compile the episode a second time)."""
    jsys, tsys, _ = systems
    want_loss, want_q, grads = jax_outer
    updates, _ = jsys.tx.update(grads, jsys.opt_state, jsys.meta_params)
    updates = jax.tree.map(lambda u, m: u * float(m), updates,
                           jsys._trainable_mask)
    want = _jax_grads_as_port(optax.apply_updates(jsys.meta_params, updates),
                              tsys)
    t_losses, preds, _, before, after = port_step
    assert preds.shape == (2, 3, 32, 32)
    np.testing.assert_allclose(t_losses["loss"], want_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(t_losses["total"], want_q, rtol=LOSS_RTOL)
    assert np.isfinite(t_losses["psnr"]) and np.isfinite(t_losses["ssim"])
    flips = total = moved = 0
    for group in ("net", "lrs"):
        for name, w in want[group].items():
            d_got = after[group][name] - before[group][name]
            d_want = w - before[group][name]
            diff = (d_got - d_want).abs()
            assert float(diff.max()) <= 2.5 * LR, (group, name)
            flips += int((diff > STEP_ATOL).sum())
            total += diff.numel()
            moved += int((d_got.abs() > 0.5 * LR).sum())
    assert flips <= STEP_FLIP_SHARE * total, (flips, total)
    assert moved > 0.1 * total, (moved, total)


def _optax_tx(rule):
    return jax_system.make_outer_optimizer(
        JaxConfig(model="sepconv", optimizer=rule, outer_lr=1e-2))


@pytest.mark.parametrize("rule", ["Adam", "Adamax", "SGD"])
def test_outer_optimizer_matches_optax(rule):
    """Three masked updates of each rule on random arrays, one leaf with a
    zero gradient throughout and one frozen by the mask (given no
    gradient, as run_train_iter gives it): the parameters and, for Adam
    and Adamax, both moments of every trainable leaf against optax's."""
    rs = np.random.RandomState(1)
    params = {"net": {"a": rs.randn(3, 4).astype(np.float32),
                      "z": rs.randn(5).astype(np.float32)},
              "lrs": {"a": rs.rand(3, 4).astype(np.float32),
                      "z": rs.rand(5).astype(np.float32)}}
    mask = {"net": {"a": True, "z": True}, "lrs": {"a": True, "z": False}}
    tx = _optax_tx(rule)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = tx.init(jp)
    tp = {g: {k: torch.tensor(v) for k, v in t.items()}
          for g, t in params.items()}
    opt = system.make_outer_optimizer(
        rule, [v for t in tp.values() for v in t.values()], 1e-2)
    second = {"Adam": "exp_avg_sq", "Adamax": "exp_inf"}.get(rule)
    for _ in range(3):
        grads = {g: {k: (rs.randn(*v.shape).astype(np.float32) * 1e-2
                         if k != "z" or g != "net" else np.zeros_like(v))
                     for k, v in t.items()} for g, t in params.items()}
        fmask = jax.tree.map(float, mask)
        jg = jax.tree.map(lambda g, m: jnp.asarray(g) * m, grads, fmask)
        ju, jstate = tx.update(jg, jstate, jp)
        ju = jax.tree.map(lambda u, m: u * m, ju, fmask)
        jp = optax.apply_updates(jp, ju)
        for g, t in tp.items():
            for k, v in t.items():
                v.grad = torch.from_numpy(grads[g][k]) if mask[g][k] else None
        opt.step()
        for g in params:
            for k in params[g]:
                # p + u cancels where p ≈ −u: an absolute limit of the
                # updates' own error, 3 steps of ~1e-2 at OPT_RTOL, rounded
                # up
                np.testing.assert_allclose(
                    tp[g][k].numpy(), np.asarray(jp[g][k]), rtol=OPT_RTOL,
                    atol=1e-7, err_msg=f"{rule} params {g}/{k}")
                if second is None or not mask[g][k]:
                    continue
                moments = jstate.inner_state[0]
                state = opt.state[tp[g][k]]
                for mine, theirs in ((state["exp_avg"], moments.mu[g][k]),
                                     (state[second], moments.nu[g][k])):
                    np.testing.assert_allclose(
                        mine.numpy(), np.asarray(theirs), rtol=OPT_RTOL,
                        atol=OPT_ATOL, err_msg=f"{rule} moments {g}/{k}")
    assert torch.equal(tp["net"]["z"], torch.from_numpy(params["net"]["z"]))
    assert torch.equal(tp["lrs"]["z"], torch.from_numpy(params["lrs"]["z"]))
    assert tp["lrs"]["z"] not in opt.state


def test_outer_rate_follows_the_plateau_schedule():
    """The rate epoch_end sets in the optimizer once the schedule decays,
    against optax's update with that rate injected into its state."""
    p = torch.zeros(2)
    holder = types.SimpleNamespace(
        scheduler=system.PlateauScheduler(1e-2, patience=0),
        outer_opt=system.make_outer_optimizer("Adamax", [p], 1e-2))
    for metric in (1.0, 1.0):
        system.SceneAdaptiveInterpolation.epoch_end(holder, metric)
    lr = holder.scheduler.lr
    assert lr == pytest.approx(2e-3)
    assert holder.outer_opt.param_groups[0]["lr"] == lr
    tx = _optax_tx("Adamax")
    jstate = tx.init({"a": jnp.zeros(2)})
    jstate.hyperparams["learning_rate"] = jnp.asarray(lr)
    g = np.asarray([0.5, -0.25], np.float32)
    ju, _ = tx.update({"a": jnp.asarray(g)}, jstate)
    p.grad = torch.from_numpy(g)
    holder.outer_opt.step()
    # p was 0, so p is the update
    np.testing.assert_allclose(p.numpy(), np.asarray(ju["a"]), rtol=OPT_RTOL)


def test_plateau_scheduler_matches_jax():
    metrics = [1.0, 0.9, 0.9, 0.89995, 0.95, 0.93, 0.92, 0.91, 0.905, 0.9,
               0.8, 0.8, 0.8, 0.8, 0.8, 0.8, 0.8, 0.8, 0.8, 0.8, 0.8, 0.8,
               0.8, 0.8, float("inf"), 0.1]
    want = jax_system.PlateauScheduler(1e-3)
    got = system.PlateauScheduler(1e-3)
    trace = [(got.step(m), want.step(m)) for m in metrics]
    assert [t[0] for t in trace] == [t[1] for t in trace]
    assert trace[-2][0] < 1e-3     # it did decay
    assert (got.best, got.bad_epochs) == (want.best, want.bad_epochs)


# LSLR rates (learnable, one per tensor and step) in place of Meta-SGD's:
# the checkpoint holds the net and its two Adamax moments, 261 MB
SMALL = dict(CFG, batch_size=1, number_of_training_steps_per_iter=1,
             use_multi_step_loss_optimization=False, metasgd=False,
             learnable_per_layer_per_step_inner_loop_learning_rate=True)


def test_resumed_run_continues_bit_equal(tmp_path):
    """Two iterations with an epoch end between them, against the first,
    its checkpoint written and read back into a fresh system, and the
    second."""
    clips = SyntheticSeptuplet(model="sepconv", mode="train", size=(32, 32))
    frames = [np.asarray(clips[i][0])[None] for i in range(2)]
    cfg = Config(**SMALL, device="cpu")

    def fresh():
        return system.SceneAdaptiveInterpolation(cfg)

    def second_half(sys_):
        sys_.epoch_end(0.5)
        sys_.run_train_iter(frames[1], 1)
        return sys_.state_dict()

    whole = fresh()
    whole.run_train_iter(frames[0], 0)
    bridge.save_checkpoint({"epoch": 1, "system": whole.state_dict()},
                           str(tmp_path))
    want = second_half(whole)
    assert [p.name for p in tmp_path.iterdir()] == ["checkpoint.pth"]
    resumed = fresh()
    resumed.load_state_dict(bridge.load_checkpoint(str(tmp_path))["system"])
    got = second_half(resumed)

    assert got["epoch"] == want["epoch"] == 1
    assert got["scheduler"] == want["scheduler"]
    assert {float(st["step"]) for st in got["opt_state"]["state"].values()
            } == {2.0}
    def leaves(tree, path=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, path + (k,))
        else:
            yield path, tree

    got_leaves = dict(leaves(got))
    for path, value in leaves(want):
        if torch.is_tensor(value):
            assert torch.equal(got_leaves[path], value), path
        else:
            assert got_leaves[path] == value, path
    (tmp_path / "checkpoint.pth").unlink()


def test_fix_loaded_matches_jax(systems, tmp_path):
    """A partial reference-named .pth: the encoder's first blocks, one
    tensor of the wrong shape and one of a kernel subnet."""
    jsys, tsys, _ = systems
    state = tsys.model.state_dict()
    partial = {k: v for k, v in state.items()
               if k.startswith(("moduleConv1.", "moduleConv2.",
                                "moduleVertical1.0."))}
    partial["moduleConv3.0.weight"] = torch.zeros(1, 1, 3, 3)
    pth = tmp_path / "partial.pth"
    torch.save(partial, pth)

    jsys = copy.copy(jsys)
    jsys._trainable_mask = dict(jsys._trainable_mask)
    jsys._jit_cache = {}
    jsys.builder = copy.copy(jsys.builder)
    _, j_loaded = jax_ckpt.import_pth(str(pth), jsys.meta_params["net"],
                                      return_mask=True)
    jsys.freeze_loaded(j_loaded)

    tsys = copy.copy(tsys)
    tsys.trainable = dict(tsys.trainable)
    tsys.builder = copy.copy(tsys.builder)
    _, loaded = bridge.import_pth(str(pth), tsys.model.state_dict())
    tsys.freeze_loaded(loaded)

    assert tsys.trainable["net"] == _names(jsys._trainable_mask["net"])
    assert tsys.builder.inner_keep == _names(jsys.builder._inner_keep)
    assert sum(loaded.values()) == len(partial) - 1
    assert not tsys.trainable["net"]["moduleConv1.0.weight"]
    assert tsys.trainable["net"]["moduleConv3.0.weight"]
    assert not tsys.builder.inner_keep["moduleVertical1.0.bias"]
    assert tsys.trainable["lrs"] == {k: True for k in state}
    pth.unlink()


# -- the episode on a two-conv model: 3 inner steps, MSL, both orders --------

class _Tiny(torch.nn.Module):
    """pred = b(tanh(a([f0, f1]))): ``a`` adapts in the inner loop, ``b``
    is inner-frozen and outer-trainable, as SepConv's kernel subnets."""

    def __init__(self):
        super().__init__()
        self.a = torch.nn.Conv2d(6, 4, 3, padding=1)
        self.b = torch.nn.Conv2d(4, 3, 3, padding=1)

    def forward(self, f0, f1):
        return self.b(torch.tanh(self.a(torch.cat([f0, f1], 1))))


def _jax_tiny(params, f0, f1):
    def conv(x, p):
        return jax.lax.conv_general_dilated(
            x, p["kernel"], (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC")) + p["bias"]
    return conv(jnp.tanh(conv(jnp.concatenate([f0, f1], -1), params["a"])),
                params["b"])


TINY_STEPS = 3


@pytest.fixture(scope="module")
def tiny():
    from meta_interpolation_tpu.core import losses as jax_losses
    from meta_interpolation_tpu.meta import inner_optimizers as jax_inner
    from meta_interpolation_tpu_torch.core import losses
    from meta_interpolation_tpu_torch.meta import episode, inner_optimizers
    rs = np.random.RandomState(3)
    tree = {"a": {"kernel": rs.randn(3, 3, 6, 4) * 0.3,
                  "bias": rs.randn(4) * 0.1},
            "b": {"kernel": rs.randn(3, 3, 4, 3) * 0.3,
                  "bias": rs.randn(3) * 0.1}}
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), tree)
    lrs = jax.tree.map(lambda x: (1e-2 * (1 + rs.rand(*x.shape))).astype(
        np.float32), tree)
    frames = rs.rand(7, 8, 8, 3).astype(np.float32)
    model = _Tiny()
    keep = {"a.weight": True, "a.bias": True, "b.weight": False,
            "b.bias": False}
    jmask = {"a": {"kernel": 1.0, "bias": 1.0},
             "b": {"kernel": 0.0, "bias": 0.0}}
    jbuilder = jax_episode.EpisodeBuilder(
        _jax_tiny,
        lambda pred, target, aux=None: {"total": jax_losses.l1_loss(
            pred, target)},
        jax_inner.InnerOptimizer("Adamax", "metasgd", TINY_STEPS),
        inner_mask=jax.tree.map(jnp.float32, jmask),
        outer_keep=jax.tree.map(lambda _: True, jmask))
    builder = episode.EpisodeBuilder(
        model, losses.make_loss_fn("1*L1"),
        inner_optimizers.InnerOptimizer("Adamax", "metasgd", TINY_STEPS),
        inner_keep=keep)
    meta = {"net": bridge.params_from_jax(tree, model),
            "lrs": bridge.params_from_jax(lrs, model)}
    jmeta = jax.tree.map(jnp.asarray, {"net": tree, "lrs": lrs})
    tframes = torch.from_numpy(np.ascontiguousarray(
        frames.transpose(0, 3, 1, 2)))
    return jbuilder, builder, jmeta, meta, jnp.asarray(frames), tframes, model


def _tiny_port_grads(tiny, second_order, msl=True):
    from meta_interpolation_tpu_torch.meta import episode
    _, builder, _, meta, _, frames, _ = tiny
    spec = episode.EpisodeSpec(num_steps=TINY_STEPS,
                               second_order=second_order, use_msl=msl)
    w = episode.per_step_loss_importance(TINY_STEPS, 0, 2)
    leaves = {g: {k: v.clone().requires_grad_() for k, v in t.items()}
              for g, t in meta.items()}
    outer, _, q = builder.task_episode(leaves, frames, w, spec,
                                       training=True)
    outer.backward()
    return float(outer), float(q), {
        g: {k: torch.zeros_like(v) if v.grad is None else v.grad
            for k, v in t.items()} for g, t in leaves.items()}


TINY_RTOL = 1e-4


@pytest.mark.parametrize("second_order", [False, True])
def test_training_episode_matches_jax(tiny, second_order):
    """The outer loss of 3 inner steps under MSL (steps 0 and 1 add their
    query losses, weighted as epoch 0 of 2 weights them) and its gradient
    w.r.t. the net and the Meta-SGD rates, against jax.grad of the JAX
    task episode."""
    jbuilder, _, jmeta, _, jframes, _, model = tiny
    jspec = jax_episode.EpisodeSpec(num_steps=TINY_STEPS,
                                    second_order=second_order, use_msl=True)
    w = jnp.asarray(jax_episode.per_step_loss_importance(TINY_STEPS, 0, 2))

    def outer(mp):
        o, _, q = jbuilder.task_episode(mp, jframes, w, jspec, training=True)
        return o, q

    (j_outer, j_q), j_grads = jax.value_and_grad(outer, has_aux=True)(jmeta)
    got_outer, got_q, got = _tiny_port_grads(tiny, second_order)
    np.testing.assert_allclose(got_outer, float(j_outer), rtol=1e-5)
    np.testing.assert_allclose(got_q, float(j_q), rtol=1e-5)
    assert got_outer != got_q      # the MSL terms are in
    np_grads = jax.tree.map(np.asarray, j_grads)
    for group in ("net", "lrs"):
        want = bridge.params_from_jax(np_grads[group], model)
        for name, w_ in want.items():
            g = got[group][name]
            err, ref = float((g - w_).norm()), float(w_.norm())
            assert err <= TINY_RTOL * ref + 1e-9, (group, name, err, ref)
    if second_order:
        # the cross term d(inner grad of a)/d(b) reaches b's gradient
        first = _tiny_port_grads(tiny, False)[2]
        diff = float((got["net"]["b.weight"] - first["net"]["b.weight"])
                     .norm())
        assert diff > 1e-3 * float(first["net"]["b.weight"].norm())
