"""The port's DAIN scene-adaptive evaluation held against the JAX package
on the CPU: the scripts/run_dain.sh hyperparameters (Adamax, Meta-SGD,
inner lr 1e-5, 1 training and 1 evaluation step; DAIN trains on its own
charbonnier whatever --loss says) on a 64×64 synthetic clip, tamed
random weights bridged from JAX.

  * float64: one evaluation step of the port's episode engine against a
    reference composed from JAX package functions (``dain.apply`` with
    ``fill_holes=True``, ``jax.grad`` over rectifyNet, the JAX inner
    optimizer). The JAX system casts to float32 and cannot run in float64.
  * the CLI on the CPU, with a tamed ``--pretrained_model``.

The float32 ``run_validation_iter`` comparison of the two systems is in
tests/test_torch_dain_system.py (its JAX episode compile alone takes
~40 s here).
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meta_interpolation_tpu.config import Config as JaxConfig
from meta_interpolation_tpu.meta.inner_optimizers import (
    make_inner_optimizer as jax_inner_optimizer)
from meta_interpolation_tpu.models.dain import model as jax_dain
from meta_interpolation_tpu.models.dain import rectify as jax_rectify
from meta_interpolation_tpu_torch.config import Config
from meta_interpolation_tpu_torch.core import checkpoint as bridge
from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
from meta_interpolation_tpu_torch.data.loader import (
    MetaLearningSystemDataLoader)
from meta_interpolation_tpu_torch.main import main
from meta_interpolation_tpu_torch.meta import episode
from meta_interpolation_tpu_torch.meta.system import (
    SceneAdaptiveInterpolation)
from meta_interpolation_tpu_torch.models.dain.model import (
    DAIN, tame_depth_head_)
from meta_interpolation_tpu_torch.ops import flow_projection_bounded as fpb

LR = 1e-5
CFG = dict(model="dain", optimizer="Adamax", metasgd=True, inner_lr=LR,
           loss="1*L1", number_of_training_steps_per_iter=1,
           number_of_evaluation_steps_per_iter=1, val_batch_size=1,
           crop_size=64, mode="val")
SUPPORT = ((0, 2, 4), (2, 4, 6))
QUERY = (2, 3, 4)
# float64. The adapted weights: Adamax's first step is lr·g/(|g| + eps);
# both sides keep the Meta-SGD rates in float32 but divide them by a bias
# correction of float32 (JAX) or float64 (port) precision, ~2e-7 apart
# relative, so steps of 1e-5 differ by up to ~1e-11.
F64_STEP_ATOL = 1e-11
# the query forward on the same adapted weights: rounding only
F64_PRED_ATOL = 1e-9
# the query on each side's own adapted weights: the ~1e-12 step
# differences of 3.6 M rectify weights add up (measured ~1e-6)
F64_OWN_PRED_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """One intra-op thread while this file runs: the tier-1 run puts six
    test files side by side on one host, and DAIN's CPU forwards with a
    thread per core each slow every file down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tamed_jax_params():
    p = jax_dain.init(jax.random.PRNGKey(0))
    last = str(max(int(k) for k in p["depthNet"]))
    p["depthNet"][last]["kernel"] = p["depthNet"][last]["kernel"] * 1e-4
    p["depthNet"][last]["bias"] = p["depthNet"][last]["bias"] * 0.0
    return jax.tree.map(np.asarray, p)


@pytest.fixture(scope="module")
def jax_params():
    return _tamed_jax_params()


@pytest.fixture(scope="module")
def clip():
    frames, _ = SyntheticSeptuplet(model="dain", mode="val",
                                   size=(64, 64))[0]
    return np.asarray(frames)


@contextlib.contextmanager
def _x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def _rectify_state(tree, model):
    """A JAX rectifyNet tree → the DAIN state-dict entries it holds."""
    return {f"rectifyNet.{k}": v for k, v in
            bridge.params_from_jax(tree, model.rectifyNet).items()}


def _port_system(jax_params):
    tsys = SceneAdaptiveInterpolation(Config(**CFG, device="cpu"))
    tsys.load_net(bridge.params_from_jax(jax_params, tsys.model))
    return tsys


def _pre_rectify(params, f0, f1):
    """JAX ``dain.apply`` (fill_holes=True) with its rectify net stubbed
    out: → (the rectify input, the coarse frame). Everything before the
    rectify net is frozen in the episode, so these are constants of the
    inner loop; tracing one forward instead of the full episode keeps the
    float64 compile short."""
    captured = []
    real = jax_rectify.apply

    def capture(_p, x):
        captured.append(x)
        return jnp.zeros(x.shape[:-1] + (3,), x.dtype)

    jax_rectify.apply = capture
    try:
        coarse = jax_dain.apply(params, f0, f1, fill_holes=True)
    finally:
        jax_rectify.apply = real
    return captured[0], coarse


@pytest.fixture(scope="module")
def float64_reference(jax_params, clip):
    """JAX in float64: the adapted rectifyNet and the query prediction, the
    support pairs and the query forwarded as one batch of three."""
    with _x64():
        params = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64),
                              jax_params)
        frames = jnp.asarray(clip, jnp.float64)
        pairs = SUPPORT + (QUERY,)
        rect_in, coarse = jax.jit(_pre_rectify)(
            params, frames[np.array([i0 for i0, _, _ in pairs])],
            frames[np.array([i1 for _, _, i1 in pairs])])
        assert coarse.shape[1:3] == rect_in.shape[1:3]     # no padding

        def pred(rect, k):
            return jax_rectify.apply(rect, rect_in[k:k + 1]) + coarse[k:k + 1]

        def support_loss(rect):
            return sum(jax_dain.charbonnier_loss(pred(rect, k),
                                                 frames[it][None])
                       for k, (_, it, _) in enumerate(SUPPORT))

        opt = jax_inner_optimizer(JaxConfig(**CFG))
        rect = params["rectifyNet"]
        grads = jax.grad(support_loss)(rect)
        new, _ = opt.update(rect, grads, opt.init_lrs(rect, LR),
                            opt.init_state(rect), 0)
        query = pred(new, len(SUPPORT))
        return (jax.tree.map(np.asarray, rect), jax.tree.map(np.asarray, new),
                np.asarray(query))


def test_evaluation_step_float64_matches_jax(jax_params, clip,
                                             float64_reference):
    rect0, rect1, want_pred = float64_reference
    tsys = _port_system(jax_params)
    tsys.model.double()
    net = {k: p.detach() for k, p in tsys.model.named_parameters()}
    lrs = tsys.inner_opt.init_lrs(net, LR)
    frames = torch.from_numpy(np.ascontiguousarray(
        clip.transpose(0, 3, 1, 2))).double()
    spec = episode.EpisodeSpec(support_idxs=SUPPORT, target_idxs=QUERY,
                               num_steps=1)
    adapted = tsys.builder.adapt(net, lrs, frames, spec)
    want = _rectify_state(rect1, tsys.model)
    q0, qt, q1 = QUERY
    with torch.no_grad():
        _, pred = tsys.builder._pair_loss(adapted, frames[q0], frames[q1],
                                          frames[qt])
        _, pred_jax_weights = tsys.builder._pair_loss(
            {**adapted, **want}, frames[q0], frames[q1], frames[qt])
    init = _rectify_state(rect0, tsys.model)
    moved = 0
    for name, w in want.items():
        step_got, step_want = adapted[name] - net[name], w - init[name]
        np.testing.assert_allclose(step_got.numpy(), step_want.numpy(),
                                   rtol=0, atol=F64_STEP_ATOL, err_msg=name)
        moved += int((step_got.abs() > 0.5 * LR).sum())
    assert moved > 0.5 * sum(w.numel() for w in want.values())
    for name in net:
        if not name.startswith("rectifyNet."):     # frozen in the inner loop
            assert adapted[name] is net[name] or torch.equal(adapted[name],
                                                             net[name])
    np.testing.assert_allclose(pred_jax_weights.numpy().transpose(1, 2, 0),
                               want_pred[0], rtol=0, atol=F64_PRED_ATOL)
    np.testing.assert_allclose(pred.numpy().transpose(1, 2, 0),
                               want_pred[0], rtol=0, atol=F64_OWN_PRED_ATOL)


def test_cli_val_runs_dain_on_the_cpu(tmp_path, capsys, monkeypatch):
    """The CLI with a tamed --pretrained_model on the first synthetic clip
    (the other seven add only time): finite metrics, and the exact
    projection (the meta system passes no proj_range), so no K4."""
    first = MetaLearningSystemDataLoader.get_val_batches
    monkeypatch.setattr(MetaLearningSystemDataLoader, "get_val_batches",
                        lambda self, total_batches=-1: first(self, 1))
    model = tame_depth_head_(DAIN(torch.Generator().manual_seed(0)))
    pth = tmp_path / "dain_tamed.pth"
    torch.save(model.state_dict(), pth)
    fpb.reset_launches()
    stats = main(["--model", "dain", "--mode", "val", "--dataset",
                  "synthetic", "--crop_size", "64", "--optimizer", "Adamax",
                  "--metasgd", "--inner_lr", "1e-5", "--loss", "1*L1",
                  "--number_of_training_steps_per_iter", "1",
                  "--number_of_evaluation_steps_per_iter", "1",
                  "--val_batch_size", "1", "--pretrained_model", str(pth),
                  "--checkpoint_dir", str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"loaded {len(model.state_dict())}/{len(model.state_dict())}" in out
    assert out.count("[val epoch 0] loss") == 1
    assert np.isfinite(stats["psnr"]) and np.isfinite(stats["ssim"])
    assert fpb.flow_projection_bounded.launches == 0
    for path in tmp_path.rglob("*.pth"):   # weights read: free the disk
        path.unlink()
