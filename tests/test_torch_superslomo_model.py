"""The port's SuperSloMo (meta_interpolation_tpu_torch/models/superslomo.py)
held against the JAX package on the CPU, with the JAX init bridged into
the port by name: the prediction and every aux tensor, on the exact and on
the bounded warp."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meta_interpolation_tpu.models import registry as jax_registry
from meta_interpolation_tpu.models import superslomo as jax_ssm
from meta_interpolation_tpu_torch.core import checkpoint as bridge
from meta_interpolation_tpu_torch.models import registry
from meta_interpolation_tpu_torch.models.superslomo import SuperSloMo, UNet

# two U-Nets of 23 convolutions each (up to 512 channels) and six warps in
# float32; random-init values are O(1)
PRED_ATOL = 1e-4
UNET_ATOL = 1e-5
N_PARAMS = 39_610_473
HW = (64, 64)

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree.map(np.asarray, jax_ssm.init(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def model(jax_params):
    m = SuperSloMo()
    m.load_state_dict(bridge.params_from_jax(jax_params, m))
    return m


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def test_bridge_names_and_shapes_match_model(jax_params):
    state = bridge.params_from_jax(jax_params, SuperSloMo())
    model_state = SuperSloMo().state_dict()
    assert set(state) == set(model_state)
    for name, value in state.items():
        assert value.shape == model_state[name].shape, name
    assert sum(v.numel() for v in state.values()) == N_PARAMS
    assert state["flowComp.conv1.weight"].shape == (32, 6, 7, 7)
    assert state["arbTimeFlowIntrp.conv1.weight"].shape == (32, 20, 7, 7)
    assert state["flowComp.down1.conv1.weight"].shape == (64, 32, 5, 5)
    assert state["flowComp.up1.conv2.weight"].shape == (512, 1024, 3, 3)
    assert state["arbTimeFlowIntrp.conv3.bias"].shape == (5,)
    back = bridge.params_to_jax(state, SuperSloMo())
    for path, leaf in jax.tree_util.tree_leaves_with_path(jax_params):
        node = back
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node, leaf)


def test_unet_matches_jax(jax_params):
    x = np.random.RandomState(1).rand(1, 64, 96, 20).astype(np.float32)
    want = jax.jit(jax_ssm._unet)(jax_params["arbTimeFlowIntrp"],
                                  jnp.asarray(x))
    net = UNet(20, 5)
    net.load_state_dict(bridge.params_from_jax(
        jax_params["arbTimeFlowIntrp"], net))
    with torch.no_grad():
        got = net(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=UNET_ATOL)


@pytest.mark.parametrize("warp_range,hw", [(None, HW), (4, HW),
                                           (None, (40, 56))])
def test_forward_and_aux_match_jax(jax_params, model, warp_range, hw):
    """40×56 reflect-pads to 64×64 and crops every output back."""
    rs = np.random.RandomState(7)
    f0, f1 = (rs.rand(1, *hw, 3).astype(np.float32) - 0.4 for _ in "01")
    apply = jax.jit(jax_ssm.apply, static_argnames="warp_range")
    want, want_aux = apply(jax_params, jnp.asarray(f0), jnp.asarray(f1),
                           warp_range=warp_range)
    model.warp_range = warp_range
    with torch.no_grad():
        got, aux = model(_nchw(f0), _nchw(f1))
    assert got.shape == (1, 3) + hw
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=PRED_ATOL)
    assert set(aux) == set(want_aux)
    for key, pair in aux.items():
        for t, w in zip(pair, want_aux[key]):
            assert t.shape[2:] == hw, key
            np.testing.assert_allclose(_nhwc(t), np.asarray(w),
                                       atol=PRED_ATOL, err_msg=key)


def test_port_init_is_xavier_with_zero_bias():
    m = SuperSloMo(torch.Generator().manual_seed(0))
    for name, conv, fan in [("conv1", m.flowComp.conv1, (6 + 32) * 49),
                            ("down4", m.arbTimeFlowIntrp.down4.conv1,
                             (256 + 512) * 9)]:
        w = conv.weight.detach()
        bound = np.sqrt(6.0 / fan)
        assert bound * 0.9 < float(w.abs().max()) <= bound, name
        # uniform on ±bound: variance bound²/3
        assert abs(float(w.var()) / (bound ** 2 / 3) - 1) < 0.05, name
        assert float(conv.bias.detach().abs().max()) == 0.0, name


def test_registry_builds_superslomo_with_its_kwargs():
    md = registry.get("SuperSloMo")
    assert md.returns_aux and md.inner_mask_fn is None
    assert md.trainable     # meta-trains too
    m = md.build(None, warp_range=8)
    assert isinstance(m, SuperSloMo) and m.warp_range == 8
    jmd = jax_registry.get("superslomo")
    x = np.random.RandomState(0).rand(4, 5, 3).astype(np.float32)
    want = np.asarray(jmd.normalize(x))
    np.testing.assert_array_equal(md.normalize(x), want)
    # the episode denormalizes NCHW predictions
    back = md.denormalize(torch.from_numpy(want.transpose(2, 0, 1))[None])
    np.testing.assert_array_equal(back[0].numpy().transpose(1, 2, 0),
                                  np.asarray(jmd.denormalize(want)))
