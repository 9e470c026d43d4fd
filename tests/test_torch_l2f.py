"""The port's L2F attenuation (``--attenuate``) held against the JAX package
on the CPU: the attenuator and the bridge's permutation of its layers, the
gamma each tensor gets from JAX's ``_attenuate``, SepConv's scene-adaptive
evaluation (the run_sepconv.sh preset), the outer gradient in both orders
with the attenuator's own, ×2 slow motion, DAIN's embedding size, and the
CLI.

``gamma_mult`` starts at 0, where gamma is 1 whatever the attenuator
computes, so every test sets it to 0.5 on both sides. VoxelFlow carries the
gradient cases (Meta-SGD, 1*MSE, one inner step, crop 32, the exact warp,
JAX op by op); SepConv's JAX evaluation is compiled. Limits as PERF.md §2:
gamma 1e-5, predictions 1e-4 and 1e-3 of their range (a random-init
SepConv's are ~1e-4), PSNR 1e-3 dB, the outer loss 1e-5 relative,
each tensor's outer gradient within 1e-3 of its norm at the inner SGD rule
and each group's after an inner Adam step (~lr·sign(g), see
tests/test_torch_warp_train.py).
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
from meta_interpolation_tpu_torch.config import Config
from meta_interpolation_tpu_torch.core import checkpoint as bridge
from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
from meta_interpolation_tpu_torch.main import main
from meta_interpolation_tpu_torch.meta import episode
from meta_interpolation_tpu_torch.meta.system import (
    SceneAdaptiveInterpolation)

GAMMA_MULT = 0.5
GAMMA_RTOL = 1e-5
PRED_ATOL = 1e-4
PRED_OF_RANGE = 1e-3
PSNR_TOL_DB = 1e-3
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-3
CROP = 32
VF = dict(model="voxelflow", loss="1*MSE", optimizer="Adam", metasgd=True,
          inner_lr=1e-5, outer_lr=1e-5, number_of_training_steps_per_iter=1,
          number_of_evaluation_steps_per_iter=1, crop_size=CROP,
          mode="train", batch_size=2, attenuate=True)

pytestmark = pytest.mark.usefixtures("two_threads")


@pytest.fixture(scope="module")
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def systems(**cfg):
    """A JAX system and a port system with gamma_mult set and every group
    of the JAX meta-parameters bridged in."""
    jsys = JaxSystem(JaxConfig(**cfg, jit_episode=cfg["model"] != "voxelflow"))
    jsys.meta_params["attenuator"]["gamma_mult"] = jnp.asarray(GAMMA_MULT)
    tsys = SceneAdaptiveInterpolation(Config(**cfg, device="cpu"))
    bridge.load_jax_meta_params(tsys, jax.tree.map(np.asarray,
                                                   jsys.meta_params))
    return jsys, tsys


def kept(tsys):
    return [k for k in tsys.meta_params["net"]
            if tsys.builder.att_keep is None or tsys.builder.att_keep[k]]


def clips(n, mode="train", crop=CROP, model="voxelflow"):
    data = SyntheticSeptuplet(model=model, mode=mode, size=(crop, crop))
    return np.stack([np.asarray(data[i][0]) for i in range(n)])


@pytest.fixture(scope="module")
def vf_systems():
    """VoxelFlow with every weight moved off zero (its BN biases and the
    head's bias start at zero), so each tensor's gamma shows in its
    scaling."""
    jsys, tsys = systems(**VF)
    rs = np.random.RandomState(1)
    jsys.meta_params["net"] = jax.tree.map(
        lambda a: a + jnp.asarray(1e-3 * rs.rand(*a.shape), a.dtype),
        jsys.meta_params["net"])
    bridge.load_jax_meta_params(tsys, jax.tree.map(np.asarray,
                                                   jsys.meta_params))
    return jsys, tsys


def test_attenuator_and_its_bridge_match_jax(vf_systems):
    """gamma of a random embedding: the port's attenuator on the embedding
    in named_parameters() order gives each tensor the gamma JAX's gives it
    from the embedding in jax.tree.leaves order."""
    jsys, tsys = vf_systems
    names = kept(tsys)
    jax_order = [k for k in bridge.jax_leaf_order(jax.tree.map(
        np.asarray, jsys.meta_params["net"])) if k in set(names)]
    assert sorted(jax_order) == sorted(names) and jax_order != names
    emb = dict(zip(names, np.random.RandomState(0).randn(len(names)).astype(
        np.float32) * 1e-1))
    want = jax_episode.apply_attenuator(
        jsys.meta_params["attenuator"],
        jnp.asarray([emb[k] for k in jax_order]))
    got = episode.apply_attenuator(tsys.meta_params["attenuator"],
                                   torch.tensor([emb[k] for k in names]))
    want = dict(zip(jax_order, np.asarray(want)))
    np.testing.assert_allclose(got.numpy(), [want[k] for k in names],
                               rtol=GAMMA_RTOL)
    assert float(got.min()) < 0.9 and float(got.max()) <= 1.0
    fresh = episode.init_attenuator(len(names))
    assert float(fresh["gamma_mult"]) == 0.0
    assert tuple(fresh["fc1.weight"].shape) == (len(names), len(names))
    # at the init gamma is 1 exactly, on the clip's edge: gamma_mult's
    # gradient splits there as jnp.clip's does
    att = {k: v.clone().requires_grad_(True) for k, v in
           tsys.meta_params["attenuator"].items()}
    jatt = dict(jsys.meta_params["attenuator"], gamma_mult=jnp.zeros(()))
    with torch.no_grad():
        att["gamma_mult"].zero_()
    e = torch.tensor([emb[k] for k in names])
    episode.apply_attenuator(att, e).sum().backward()
    want_g = jax.grad(lambda a: jax_episode.apply_attenuator(
        a, jnp.asarray([emb[k] for k in jax_order])).sum())(jatt)
    np.testing.assert_allclose(float(att["gamma_mult"].grad),
                               float(want_g["gamma_mult"]), rtol=1e-5)


def test_gamma_per_tensor_matches_jax(vf_systems):
    """The initialisation _attenuate scales, each tensor by its gamma from
    the support loss's first-order gradient embedding: port against JAX,
    tensor by tensor."""
    jsys, tsys = vf_systems
    frames = clips(1)[0]
    jspec = jsys._episode_spec("train", 1, False, False)
    net = jsys.meta_params["net"]
    scaled = jsys.builder._attenuate(net, jsys.meta_params["attenuator"],
                                     jnp.asarray(frames), jspec)
    want = {}
    for k, s, w in zip(bridge.jax_leaf_order(jax.tree.map(np.asarray, net)),
                       jax.tree.leaves(scaled), jax.tree.leaves(net)):
        s, w = np.asarray(s).ravel(), np.asarray(w).ravel()
        i = int(np.abs(w).argmax())
        want[k] = float(s[i] / w[i])
    got_scaled = tsys.builder._attenuate(
        tsys.meta_params["net"], tsys.meta_params["attenuator"],
        tsys._frames(frames[None])[0], tsys._spec("train", 1),
        episode.TaskState())
    gammas = []
    for k in kept(tsys):
        w = tsys.meta_params["net"][k]
        i = int(w.abs().flatten().argmax())
        gamma = float(got_scaled[k].flatten()[i] / w.flatten()[i])
        np.testing.assert_allclose(gamma, want[k], rtol=GAMMA_RTOL,
                                   err_msg=k)
        gammas.append(gamma)
    assert np.std(gammas) > 1e-4 and max(gammas) < 1.0


def test_sepconv_evaluation_matches_jax():
    """run_validation_iter of the run_sepconv.sh preset (Adamax, Meta-SGD)
    with --attenuate, one inner step at crop 64 on the first validation
    clip: the prediction and the PSNR."""
    jsys, tsys = systems(model="sepconv", optimizer="Adamax", metasgd=True,
                         inner_lr=1e-5, number_of_evaluation_steps_per_iter=1,
                         crop_size=64, mode="val", loss="1*L1",
                         attenuate=True)
    frames = clips(1, "val", 64, "sepconv")
    j_losses, j_preds = jsys.run_validation_iter(frames)
    t_losses, t_preds = tsys.run_validation_iter(frames)
    got, want = t_preds.numpy().transpose(0, 2, 3, 1), np.asarray(j_preds)
    np.testing.assert_allclose(got, want, atol=PRED_ATOL)
    # random-init predictions are small: hold them to their range too
    assert np.abs(got - want).max() <= PRED_OF_RANGE * np.abs(want).max()
    assert abs(t_losses["psnr"] - j_losses["psnr"]) <= PSNR_TOL_DB
    # the attenuation acts: gamma_mult at 0 predicts otherwise
    with torch.no_grad():
        tsys.meta_params["attenuator"]["gamma_mult"].zero_()
    _, plain = tsys.run_validation_iter(frames)
    assert float((plain - t_preds).abs().max()) > 0.1 * np.abs(want).max()


@pytest.mark.parametrize("order", ["first", "second"])
def test_outer_gradient_matches_jax(order):
    """The outer loss and gradient of a batch of two, with the
    attenuator's: first order at the preset's inner Adam (each group),
    second order at the inner SGD rule (each tensor)."""
    extra = ({} if order == "first" else
             dict(optimizer="SGD", second_order=True))
    jsys, tsys = systems(**dict(VF, **extra))
    frames = clips(2)
    spec = jsys._episode_spec("train", 1, order == "second", False)

    def outer(mp, task):
        return jsys.builder.task_episode(mp, task, jnp.ones((1,)), spec,
                                         training=True)[0]

    runs = [jax.value_and_grad(outer)(jsys.meta_params, jnp.asarray(task))
            for task in frames]
    want = jax.tree.map(lambda *g: np.asarray(sum(g) / len(g)),
                        *[g for _, g in runs])
    loss, _, got = tsys.outer_grads(frames, 0)
    np.testing.assert_allclose(float(loss), sum(float(o) for o, _ in runs)
                               / len(runs), rtol=LOSS_RTOL)
    refs = {"net": bridge.params_from_jax(want["net"], tsys.model),
            "lrs": bridge.params_from_jax(want["lrs"], tsys.model),
            "attenuator": bridge.attenuator_from_jax(
                want["attenuator"], jax.tree.map(
                    np.asarray, jsys.meta_params["net"]), kept(tsys))}
    for group, ref in refs.items():
        pairs = [(k, got[group][k], ref[k]) for k in tsys.meta_params[group]]
        if order == "first":
            pairs = [(group, torch.cat([g.flatten() for _, g, _ in pairs]),
                      torch.cat([w.flatten() for _, _, w in pairs]))]
        for name, g, w in pairs:
            err = float((g - w).norm())
            assert err <= GRAD_RTOL * float(w.norm()) + 1e-12, (
                group, name, err, float(w.norm()))
    assert float(got["attenuator"]["gamma_mult"].abs()) > 0
    assert all(tsys.trainable["attenuator"].values())


def test_slow_motion_matches_jax(vf_systems):
    """run_test_iter attenuates before it adapts, as JAX's test_episode."""
    jsys, tsys = vf_systems
    quad = clips(2, "val")[:, 1:5]
    want = jsys.run_test_iter(quad)
    got = tsys.run_test_iter(quad)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), atol=PRED_ATOL)


def test_dain_embeds_rectify_net_only():
    """DAIN's attenuator is sized on its outer mask, rectifyNet's tensors
    (JAX meta/system.py:186-200): the same L and the same kept tensors as
    JAX's, without running an episode."""
    cfg = dict(model="dain", optimizer="Adamax", metasgd=True,
               inner_lr=1e-5, loss="1*L1", attenuate=True, crop_size=64,
               number_of_training_steps_per_iter=1)
    jsys = JaxSystem(JaxConfig(**cfg))
    tsys = SceneAdaptiveInterpolation(Config(**cfg, device="cpu"))
    names = kept(tsys)
    jax_kept = [k for k, keep in zip(
        bridge.jax_leaf_order(jax.tree.map(np.asarray,
                                           jsys.meta_params["net"])),
        jax.tree.leaves(jsys._att_keep)) if keep]
    assert sorted(names) == sorted(jax_kept)
    assert all(k.startswith("rectifyNet.") for k in names)
    n = len(names)
    assert n == jax.tree.leaves(jsys.meta_params["attenuator"])[0].shape[0]
    assert tuple(tsys.meta_params["attenuator"]["fc1.weight"].shape) == (n, n)
    assert n < len(tsys.meta_params["net"])


def test_cli_trains_and_evaluates_with_attenuation_on_the_cpu(tmp_path,
                                                               capsys):
    """The training CLI with --attenuate: two iterations, a validation and
    a checkpoint that carries the attenuator, which --resume reads back;
    without a card, --device cuda raises."""
    argv = ["--model", "voxelflow", "--mode", "train", "--dataset",
            "synthetic", "--crop_size", str(CROP), "--batch_size", "1",
            "--optimizer", "Adam", "--metasgd", "--loss", "1*MSE",
            "--inner_lr", "1e-5", "--outer_lr", "1e-5",
            "--number_of_training_steps_per_iter", "1",
            "--number_of_evaluation_steps_per_iter", "1",
            "--fast_warp_range", "4", "--attenuate", "--checkpoint_dir",
            str(tmp_path), "--total_iter_per_epoch", "2"]
    stats = main(argv + ["--max_epoch", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[epoch 0 it 0] loss" in out and "[val epoch 0]" in out
    assert np.isfinite(stats["best_psnr"])
    att = bridge.load_checkpoint(str(tmp_path / "exp"))["system"][
        "meta_params"]["attenuator"]
    assert float(att["gamma_mult"]) != 0.0   # the outer step moved it
    main(argv + ["--max_epoch", "1", "--resume", "--device", "cpu"])
    assert "[resume] epoch 1" in capsys.readouterr().out
    for path in tmp_path.rglob("*.pth"):   # weights read: free the disk
        path.unlink()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv + ["--max_epoch", "1", "--device", "cuda"])
