"""The port's CAIN (meta_interpolation_tpu_torch/models/cain.py) and the
layers it adds, held against the JAX package's on the CPU, with the JAX
init bridged in by name.

Tolerances: the tiny models' forwards (depth 2, 48 channels) agree to
PRED_ATOL; the full architecture's random-init prediction reaches ~10² (60
residual blocks of xavier convs), where float32 summation in another order
is ~1e-6 relative, so it is held to FULL_RTOL of its largest value. The
layers move values without arithmetic (shuffles, equal) or take a mean
(1e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meta_interpolation_tpu.config import Config as JaxConfig
from meta_interpolation_tpu.meta.system import (
    SceneAdaptiveInterpolation as JaxSystem)
from meta_interpolation_tpu.models import cain as jax_cain
from meta_interpolation_tpu.models import layers as jax_layers
from meta_interpolation_tpu_torch.config import Config
from meta_interpolation_tpu_torch.core import checkpoint as bridge
from meta_interpolation_tpu_torch.models import cain, layers, registry

PRED_ATOL = 1e-5
FULL_RTOL = 1e-5
TINY = dict(depth=2, n_resgroups=2, n_resblocks=2, reduction=4)

pytestmark = pytest.mark.usefixtures("two_threads")


@pytest.fixture(scope="module")
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _frames(hw, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.rand(1, *hw, 3).astype(np.float32) for _ in range(2)]


@pytest.fixture(scope="module")
def tiny_params():
    return jax.tree.map(np.asarray, jax_cain.init(jax.random.PRNGKey(3),
                                                  **TINY))


def _port(params, **kw):
    model = cain.CAIN(None, **kw)
    model.load_state_dict(bridge.params_from_jax(params, model))
    return model


@pytest.mark.parametrize("fuse", [
    False, True, "reflect", "RZ", "bw1", "bw1x2",
    [["reflect", True, False], "reflect"]], ids=str)
def test_forward_matches_jax_in_every_fuse_mode(tiny_params, fuse):
    """Each border mode (exact reflect, zero, the restructured reflect),
    per-group letters, the boundary-fuse points and a per-RCAB list, at
    the reference's ×128 pad (20×28 → 128×128: 54-pixel reflections)."""
    if isinstance(fuse, str) and fuse not in ("reflect",):
        fuse = jax_cain.parse_fuse_spec(fuse, n_resgroups=2, n_resblocks=2)
    f0, f1 = _frames((20, 28))
    want = jax_cain.apply(tiny_params, jnp.asarray(f0), jnp.asarray(f1),
                          depth=2, n_resgroups=2, n_resblocks=2,
                          fuse_pad=fuse)
    model = _port(tiny_params, **TINY, fuse_pad=fuse)
    with torch.no_grad():
        got = model(_nchw(f0), _nchw(f1))
    assert got.shape == (1, 3, 20, 28)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=PRED_ATOL)


@pytest.mark.parametrize("pad_multiple,apron", [(8, 0), (8, 4), (128, 4)])
def test_pad_multiple_and_apron_match_jax(tiny_params, pad_multiple, apron):
    f0, f1 = _frames((24, 32), seed=1)
    kw = dict(pad_multiple=pad_multiple, apron=apron)
    want = jax_cain.apply(tiny_params, jnp.asarray(f0), jnp.asarray(f1),
                          depth=2, n_resgroups=2, n_resblocks=2, **kw)
    model = _port(tiny_params, **TINY, **kw)
    with torch.no_grad():
        got = model(_nchw(f0), _nchw(f1))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=PRED_ATOL)


def test_reflect_mode_is_the_exact_pad(tiny_params):
    """The port computes "reflect" as the reflect pad itself, so it is
    bit for bit the exact mode."""
    f0, f1 = _frames((20, 28), seed=2)
    with torch.no_grad():
        outs = [_port(tiny_params, **TINY, fuse_pad=m)(_nchw(f0), _nchw(f1))
                for m in (False, "reflect")]
    assert torch.equal(*outs)


def test_full_architecture_matches_jax_and_counts_its_parameters():
    """Depth 3, 5 groups of 12 RCABs, 192 channels, reduction 16: the
    reference's 42,780,432 parameters; one 64×64 forward (16×16×192 after
    the ×128 pad and the ×1/8 shuffle)."""
    params = jax.tree.map(np.asarray, jax_cain.init(jax.random.PRNGKey(0)))
    model = _port(params)
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(x.size for x in jax.tree.leaves(params)) == 42_780_432
    f0, f1 = _frames((64, 64), seed=3)
    want = np.asarray(jax_cain.apply(params, jnp.asarray(f0),
                                     jnp.asarray(f1)))
    with torch.no_grad():
        got = _nhwc(model(_nchw(f0), _nchw(f1)))
    assert np.abs(want).max() > 1.0
    np.testing.assert_allclose(got, want,
                               atol=FULL_RTOL * np.abs(want).max())


@pytest.mark.parametrize("spec", ["exact", "False", "zero", "TRUE",
                                  "reflect", "RZZZZ", "XRZXR", "bw1", "bw12",
                                  "bw3x5"])
def test_parse_fuse_spec_matches_jax(spec):
    assert cain.parse_fuse_spec(spec) == jax_cain.parse_fuse_spec(spec)


@pytest.mark.parametrize("spec", ["RZZ", "bw0", "bw13", "bw1x4", "fast",
                                  "RZZZY"])
def test_unknown_fuse_groups_token_raises_as_jax(spec):
    with pytest.raises(ValueError) as want:
        jax_cain.parse_fuse_spec(spec)
    with pytest.raises(ValueError) as got:
        cain.parse_fuse_spec(spec)
    assert str(got.value) == str(want.value)


def test_group_modes_refuse_a_wrong_length():
    with pytest.raises(ValueError, match="2 residual groups"):
        cain.group_modes([True] * 3, 2, 2)
    with pytest.raises(ValueError, match="3 entries"):
        cain.group_modes([[True] * 2, True], 2, 2)
    with pytest.raises(ValueError, match="reduction 16 exceeds 12"):
        cain.CAIN(depth=1)


@pytest.mark.parametrize("flags", [
    {}, {"fuse_pad": "true"}, {"fuse_pad": "reflect", "pad_multiple": 8},
    {"fuse_groups": "RZZZZ"}, {"fuse_groups": "bw1", "fuse_pad": "true"},
    {"n_resblocks": 3, "fuse_groups": "bw2x5"}], ids=str)
def test_registry_builds_cain_from_the_flags_as_jax(flags):
    """The model flags into the model's kwargs as JAX's system builds them
    (meta/system.py:134-146); identity normalization, 5e5 tiling limit,
    trainable. A tiny CAIN (depth 2, 1 RCAB a group unless given)."""
    cfg = dict(dict(model="cain", depth=2, n_resblocks=1), **flags)
    want = JaxSystem(JaxConfig(**cfg, jit_episode=False)).model_kwargs
    md = registry.get("cain")
    got = md.build_kwargs(Config(**cfg))
    assert got == want
    assert md.trainable and md.tile_pixel_limit == 5e5
    x = np.random.RandomState(0).rand(4, 4, 3).astype(np.float32)
    assert md.normalize(x) is x and md.denormalize(x) is x
    model = md.build(None, **got)
    assert isinstance(model, cain.CAIN)
    assert model.pad_multiple == got["pad_multiple"]


@pytest.mark.parametrize("scale", [0.5, 0.25, 2.0, 8.0])
def test_pixel_shuffle_matches_jax(scale):
    c = 192 if scale > 1 else 3
    x = np.random.RandomState(4).rand(2, 16, 24, c).astype(np.float32)
    want = np.asarray(jax_layers.pixel_shuffle(jnp.asarray(x), scale))
    got = _nhwc(layers.pixel_shuffle(_nchw(x), scale))
    np.testing.assert_array_equal(got, want)


def test_sub_mean_and_global_avg_pool_match_jax():
    x = np.random.RandomState(5).rand(2, 9, 13, 3).astype(np.float32)
    want_x, want_m = jax_layers.sub_mean(jnp.asarray(x))
    got_x, got_m = layers.sub_mean(_nchw(x))
    np.testing.assert_allclose(_nhwc(got_x), np.asarray(want_x), atol=1e-6)
    np.testing.assert_allclose(_nhwc(got_m), np.asarray(want_m), atol=1e-6)
    np.testing.assert_allclose(
        _nhwc(layers.global_avg_pool(_nchw(x))),
        np.asarray(jax_layers.global_avg_pool(jnp.asarray(x))), atol=1e-6)
