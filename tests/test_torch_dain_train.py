"""The port's DAIN meta-training held against the JAX system on the CPU,
at run_dain.sh's hyperparameters with --mode train (Adamax, Meta-SGD, one
inner step, DAIN's own charbonnier) in first order, and the inner SGD rule
in second order, on a 64x64 clip.

Meta-training adapts and trains the rectify net only: everything before
it is frozen in both loops, so each forward's rectify input is a constant
of the episode. Both systems take those inputs from one JAX forward of the
tamed weights (float32 floors of the projection flip between two float32
forwards, tests/test_torch_dain_episode.py): the JAX system's
DAIN forward and the port's ``DAIN.rectify_input`` are stubbed to look
them up by frame pair, and what is held is the trained part, the episode
engine, the inner rules and the outer mask. The port's own forward, the
projection included, is held by the evaluation tests; here the real
forward shows the outer gradient zero outside rectifyNet, and the training
CLI runs on tamed weights.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_dain_episode import _pre_rectify, _tamed_jax_params
from test_torch_warp_models_episode import train_cli_on_the_cpu
from test_torch_warp_train import (  # noqa: F401 (two_threads)
    clips, hold_outer_to_jax, systems, two_threads)
from meta_interpolation_tpu.models.dain import rectify as jax_rectify
from meta_interpolation_tpu_torch.config import Config
from meta_interpolation_tpu_torch.meta.system import (
    SceneAdaptiveInterpolation)
from meta_interpolation_tpu_torch.models import layers
from meta_interpolation_tpu_torch.models.dain.model import (
    DAIN, tame_depth_head_)

CROP = 64           # DAIN pads to x64: no padding
PAIRS = ((0, 4), (2, 6), (2, 4))   # the support pairs and the query

pytestmark = pytest.mark.usefixtures("two_threads")


def config(order):
    cfg = dict(model="dain", loss="1*L1", optimizer="Adamax", metasgd=True,
               inner_lr=1e-5, outer_lr=1e-5,
               number_of_training_steps_per_iter=1,
               number_of_evaluation_steps_per_iter=1, crop_size=CROP,
               mode="train", batch_size=1)
    if order == "second":
        cfg.update(optimizer="SGD", second_order=True)
    return cfg


def _key(frame_hwc):
    return np.ascontiguousarray(frame_hwc, np.float32).tobytes()


@pytest.fixture(scope="module")
def rectify_inputs():
    """(the clip's pairs' first and second frames, their rectify inputs,
    their coarse frames), NHWC, from one JAX forward of the tamed weights
    for the clip's three pairs."""
    clip = clips("dain", 1, CROP)[0]
    f0 = jnp.asarray(clip[np.array([a for a, _ in PAIRS])])
    f1 = jnp.asarray(clip[np.array([b for _, b in PAIRS])])
    rect_in, coarse = jax.jit(_pre_rectify)(
        jax.tree.map(jnp.asarray, _tamed_jax_params()), f0, f1)
    assert coarse.shape[1:3] == rect_in.shape[1:3] == (CROP, CROP)
    return f0, f1, rect_in, coarse


@pytest.fixture
def stubbed(rectify_inputs, monkeypatch):
    """Both models' frozen part replaced by the lookup: in JAX by a 0/1
    match of the pair against the three (traceable, exact), in the port by
    the pair's bytes. Patches the port's ``DAIN.rectify_input``; returns
    the JAX forward, for the test to set as the JAX builder's
    ``apply_fn`` (the JAX registry keeps the ``dain.apply`` it was given)."""
    firsts, seconds, rect_all, coarse_all = rectify_inputs

    def jax_apply(params, f0, f1, **_kw):
        hit = (jnp.all(f0[0] == firsts, axis=(1, 2, 3))
               & jnp.all(f1[0] == seconds, axis=(1, 2, 3))
               ).astype(jnp.float32)
        rect = jnp.tensordot(hit, rect_all, axes=1)[None]
        coarse = jnp.tensordot(hit, coarse_all, axes=1)[None]
        return jax_rectify.apply(params["rectifyNet"], rect) + coarse

    table = {(_key(a), _key(b)): (rect_all[k:k + 1], coarse_all[k:k + 1])
             for k, (a, b) in enumerate(zip(np.asarray(firsts),
                                            np.asarray(seconds)))}

    def port_rectify_input(self, frame0, frame1, proj_range=None,
                           fill_holes=False):
        hwc = lambda t: t[0].detach().permute(1, 2, 0).numpy()
        rect, coarse = table[(_key(hwc(frame0)), _key(hwc(frame1)))]
        nchw = lambda a: torch.from_numpy(
            np.asarray(a).transpose(0, 3, 1, 2).copy())
        return nchw(rect), nchw(coarse), layers.pad_to_multiple(frame0,
                                                                CROP)[1]

    monkeypatch.setattr(DAIN, "rectify_input", port_rectify_input)
    return jax_apply


@pytest.mark.parametrize("order", ["first", "second"])
def test_dain_outer_loss_and_gradient_match_jax(order, stubbed):
    jsys, tsys = systems(config(order))
    jsys.builder.apply_fn = stubbed
    got = hold_outer_to_jax(jsys, tsys, clips("dain", 1, CROP), jit=True)
    assert float(got["lrs"]["rectifyNet.block1.0.weight"].norm()) > 0


def test_outer_gradient_is_zero_outside_the_rectify_net():
    """The real forward (tamed weights): only rectifyNet trains in the
    outer loop, as in the inner one; every other leaf is off the tape
    (no gradient, the optimizer keeps no moments for it)."""
    tsys = SceneAdaptiveInterpolation(Config(**config("first"),
                                             device="cpu"))
    tsys.load_net(tame_depth_head_(DAIN(torch.Generator().manual_seed(0)))
                  .state_dict())
    rect = lambda k: k.startswith("rectifyNet.")
    assert tsys.trainable["net"] == {k: rect(k) for k in tsys.trainable["net"]}
    _, _, grads = tsys.outer_grads(clips("dain", 1, CROP), 0)
    for group, tree in grads.items():
        live = [float(g.abs().max()) > 0 for k, g in tree.items() if rect(k)]
        assert not any(float(g.abs().max()) for k, g in tree.items()
                       if not rect(k)), group
        assert sum(live) >= 0.9 * len(live), group
    before = {k: v.clone() for k, v in tsys.meta_params["net"].items()}
    tsys.run_train_iter(clips("dain", 1, CROP), 0)
    moved = {k: not torch.equal(v, before[k])
             for k, v in tsys.meta_params["net"].items()}
    assert not any(m for k, m in moved.items() if not rect(k))
    assert sum(m for k, m in moved.items() if rect(k)) >= 0.9 * sum(
        map(rect, moved))
    state = tsys.outer_opt.state
    assert all(rect(k) == (v in state) for k, v in
               tsys.meta_params["net"].items())


@pytest.mark.parametrize("order", ["first", "second"])
def test_cli_trains_dain_on_the_cpu(order, tmp_path, capsys):
    train_cli_on_the_cpu("dain", order, tmp_path, capsys)
