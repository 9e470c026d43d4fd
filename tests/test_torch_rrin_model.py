"""The port's RRIN model and U-Net (meta_interpolation_tpu_torch/models/
rrin.py, models/unet.py) held against the JAX package on the CPU, with the
JAX init bridged into the port by name."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meta_interpolation_tpu.models import rrin as jax_rrin
from meta_interpolation_tpu.models import unet as jax_unet
from meta_interpolation_tpu_torch.core import checkpoint as bridge
from meta_interpolation_tpu_torch.models import registry
from meta_interpolation_tpu_torch.models.rrin import RRIN, inner_mask
from meta_interpolation_tpu_torch.models.unet import UNet

# four U-Nets (~60 convolutions) and two warps in float32
PRED_ATOL = 1e-4
UNET_ATOL = 1e-5
N_PARAMS = 19_194_445


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree.map(np.asarray, jax_rrin.init(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def model(jax_params):
    m = RRIN()
    m.load_state_dict(bridge.params_from_jax(jax_params, m))
    return m


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def test_bridge_names_and_shapes_match_model(jax_params):
    state = bridge.params_from_jax(jax_params, RRIN())
    model_state = RRIN().state_dict()
    assert set(state) == set(model_state)
    for name, value in state.items():
        assert value.shape == model_state[name].shape, name
    assert sum(v.numel() for v in state.values()) == N_PARAMS
    for name in ("Flow_L.down_path.4.block.2.weight", "Mask.midconv.bias",
                 "final.up_path.2.up.1.weight",
                 "refine_flow.up_path.0.conv_block.block.0.weight",
                 "final.last.weight"):
        assert name in state, name


@pytest.mark.parametrize("depth,in_ch,out_ch,hw", [(4, 10, 4, (32, 48)),
                                                   (5, 6, 4, (32, 32))])
def test_unet_matches_jax(jax_params, depth, in_ch, out_ch, hw):
    key = {4: "refine_flow", 5: "Flow_L"}[depth]
    x = np.random.RandomState(depth).rand(1, *hw, in_ch).astype(np.float32)
    want = jax_unet.apply(jax_params[key], jnp.asarray(x), depth=depth)
    net = UNet(in_ch, out_ch, depth)
    net.load_state_dict(bridge.params_from_jax(jax_params[key], net))
    with torch.no_grad():
        got = net(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=UNET_ATOL)


def test_port_init_is_xavier_with_zero_bias():
    net = UNet(6, 4, 5, generator=torch.Generator().manual_seed(0))
    w = net.down_path[1].block[0].weight.detach()
    bound = np.sqrt(6.0 / ((32 + 64) * 9))
    assert bound * 0.9 < float(w.abs().max()) <= bound
    assert float(net.down_path[1].block[0].bias.detach().abs().max()) == 0.0


@pytest.mark.parametrize("warp_range", [None, 4])
@pytest.mark.parametrize("hw", [(64, 64), (40, 40)])
def test_forward_matches_jax(jax_params, model, hw, warp_range):
    """40×40 reflect-pads 44 px a side to 128, wider than the crop."""
    rs = np.random.RandomState(hw[0])
    f0 = rs.rand(1, *hw, 3).astype(np.float32)
    f1 = rs.rand(1, *hw, 3).astype(np.float32)
    apply = jax.jit(jax_rrin.apply, static_argnames="warp_range")
    want = apply(jax_params, jnp.asarray(f0), jnp.asarray(f1),
                 warp_range=warp_range)
    model.warp_range = warp_range
    with torch.no_grad():
        got = model(_nchw(f0), _nchw(f1))
    assert got.shape == (1, 3) + hw
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=PRED_ATOL)


def test_inner_mask_matches_jax(jax_params):
    mask = inner_mask(RRIN())
    jmask = bridge.params_from_jax(jax.tree.map(
        lambda m, p: np.full(p.shape, m), jax_rrin.inner_mask(jax_params),
        jax_params), RRIN())
    assert {k: bool(v.all()) for k, v in jmask.items()} == mask
    assert not mask["Mask.down_path.0.block.0.weight"]
    assert mask["Flow_L.down_path.0.block.0.weight"]
    assert mask["final.last.bias"]


def test_registry_builds_rrin_with_its_kwargs():
    md = registry.get("RRIN")
    assert md.tile_pixel_limit == 3e5
    assert md.inner_mask_fn is inner_mask
    m = md.build(None, warp_range=8)
    assert isinstance(m, RRIN) and m.warp_range == 8
    assert md.build(None).warp_range is None
    # every backbone is ported; a name the registry does not know is
    # refused with the list
    with pytest.raises(NotImplementedError, match="available: .*'cain'"):
        registry.get("nosuchmodel")
