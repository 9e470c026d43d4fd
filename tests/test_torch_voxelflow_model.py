"""The port's VoxelFlow (meta_interpolation_tpu_torch/models/voxelflow.py),
its sampler (ops/warp.voxelflow_sample) and its frozen batch norm held
against the JAX package on the CPU, with the JAX init bridged into the
port by name; the inner mask with and without
--enable_inner_loop_optimizable_bn_params."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meta_interpolation_tpu.config import Config as JaxConfig
from meta_interpolation_tpu.meta.system import (
    SceneAdaptiveInterpolation as JaxSystem)
from meta_interpolation_tpu.models import registry as jax_registry
from meta_interpolation_tpu.models import voxelflow as jax_vf
from meta_interpolation_tpu.ops import warp as jax_warp
from meta_interpolation_tpu_torch.config import Config
from meta_interpolation_tpu_torch.core import checkpoint as bridge
from meta_interpolation_tpu_torch.meta.system import (
    SceneAdaptiveInterpolation)
from meta_interpolation_tpu_torch.models import registry
from meta_interpolation_tpu_torch.models.voxelflow import VoxelFlow
from meta_interpolation_tpu_torch.ops import warp

# ten convolutions, frozen BN and two bilinear samples in float32; outputs
# are frames in [-1, 1]. A sample coordinate near 63 px carries float32
# rounding of ~4e-6 px, and neighbouring pixels of the random frames
# differ by up to 2, so the coordinate alone moves a sample by ~1e-5
PRED_ATOL = 3e-5
N_PARAMS = 3_821_891        # parameters, BN statistics not counted
N_BN_STATS = 2 * (64 + 128 + 256 + 256 + 256 + 128 + 64)
HW = (64, 64)


def _jax_params():
    """JAX's init with every BN's statistics and affine drawn at random,
    so that BN is no identity and the flow moves samples by up to ~5
    pixels, past R = 4 in places (test_flow_reaches_past_the_warp_range)."""
    params = jax.tree.map(np.asarray, jax_vf.init(jax.random.PRNGKey(0)))
    rs = np.random.RandomState(3)
    for name in jax_vf.BN_NAMES:
        ch = params[name]["mean"].shape[0]
        params[name] = {
            "scale": rs.uniform(0.5, 2.0, ch).astype(np.float32),
            "bias": rs.uniform(-0.2, 0.2, ch).astype(np.float32),
            "mean": rs.uniform(-0.01, 0.01, ch).astype(np.float32),
            "var": rs.uniform(0.1, 0.5, ch).astype(np.float32)}
    return params


@pytest.fixture(scope="module")
def jax_params():
    return _jax_params()


def _model(jax_params, **kw):
    m = VoxelFlow(**kw)
    m.load_state_dict(bridge.params_from_jax(jax_params, m))
    return m


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _frames(hw, seed=5):
    rs = np.random.RandomState(seed)
    return (rs.rand(1, *hw, 3).astype(np.float32) * 2 - 1 for _ in "01")


def test_bridge_puts_bn_statistics_in_buffers(jax_params):
    m = _model(jax_params)
    state = bridge.params_from_jax(jax_params, m)
    assert set(state) == set(m.state_dict())
    params, buffers = dict(m.named_parameters()), dict(m.named_buffers())
    assert sum(p.numel() for p in params.values()) == N_PARAMS
    assert sum(b.numel() for b in buffers.values()) == N_BN_STATS
    for name in jax_vf.BN_NAMES:
        for jkey, tkey in (("mean", "running_mean"), ("var", "running_var")):
            assert f"{name}.{tkey}" in buffers
            np.testing.assert_array_equal(buffers[f"{name}.{tkey}"].numpy(),
                                          jax_params[name][jkey])
        np.testing.assert_array_equal(params[f"{name}.weight"].detach(),
                                      jax_params[name]["scale"])
    assert "conv1.bias" not in params and "conv4.bias" in params
    back = bridge.params_to_jax(state, m)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jax_params):
        node = back
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node, leaf)


@pytest.mark.parametrize("syn_type,warp_range,hw", [
    ("inter", None, HW), ("inter", 4, HW), ("extra", None, HW),
    ("inter", None, (40, 56))])
def test_forward_matches_jax(jax_params, syn_type, warp_range, hw):
    """40×56 reflect-pads to 64×64 and crops back; 'extra' takes the
    exact sampler whatever the warp range."""
    f0, f1 = _frames(hw)
    apply = jax.jit(jax_vf.apply, static_argnames=("syn_type", "warp_range"))
    want = apply(jax_params, jnp.asarray(f0), jnp.asarray(f1),
                 syn_type=syn_type, warp_range=warp_range)
    m = _model(jax_params, syn_type=syn_type, warp_range=warp_range)
    with torch.no_grad():
        got = m(_nchw(f0), _nchw(f1))
    assert got.shape == (1, 3) + hw
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=PRED_ATOL)


def test_flow_reaches_past_the_warp_range(jax_params):
    """The forward above samples within and past R = 4."""
    f0, f1 = _frames(HW)
    with warp.FlowStats(r=4) as fs, torch.no_grad():
        _model(jax_params)(_nchw(f0), _nchw(f1))
    assert fs.calls == 2
    assert 0.01 < fs.frac_beyond < 0.99 and fs.max_disp > 4


@pytest.mark.parametrize("warp_range", [None, 4])
def test_voxelflow_sample_matches_jax(warp_range):
    rs = np.random.RandomState(11)
    n, (h, w) = 2, (37, 53)
    f0, f1 = (rs.rand(n, h, w, 3).astype(np.float32) for _ in "01")
    flow = (rs.rand(n, h, w, 2).astype(np.float32) - 0.5) * 0.3
    mask = rs.rand(n, h, w, 1).astype(np.float32) * 2 - 1
    want = jax.jit(jax_warp.voxelflow_sample, static_argnames="warp_range")(
        *map(jnp.asarray, (f0, f1, flow, mask)), warp_range=warp_range)
    got = warp.voxelflow_sample(_nchw(f0), _nchw(f1), torch.from_numpy(flow),
                                _nchw(mask), warp_range=warp_range)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=PRED_ATOL)


def _jax_extrapolate(f0, f1, flow, mask):
    """JAX VoxelFlow's extrapolating samples (models/voxelflow.py:195-207):
    frame0 at linspace − 2·flow, frame1 at linspace − flow, exact."""
    h, w = f0.shape[1:3]
    gx = jnp.linspace(-1.0, 1.0, w)[None, None, :]
    gy = jnp.linspace(-1.0, 1.0, h)[None, :, None]
    u, v = flow[..., 0], flow[..., 1]
    out1 = jax_warp.grid_sample(f0, jnp.stack([gx - 2 * u, gy - 2 * v], -1),
                                align_corners=True, padding_mode="border")
    out2 = jax_warp.grid_sample(f1, jnp.stack([gx - u, gy - v], -1),
                                align_corners=True, padding_mode="border")
    m = 0.5 * (1.0 + mask)
    return m * out1 + (1.0 - m) * out2


@pytest.mark.parametrize("hw", [(37, 53), (64, 64)])
def test_voxelflow_sample_extrapolating_offsets_match_jax(hw):
    rs = np.random.RandomState(12)
    n, (h, w) = 2, hw
    f0, f1 = (rs.rand(n, h, w, 3).astype(np.float32) for _ in "01")
    flow = (rs.rand(n, h, w, 2).astype(np.float32) - 0.5) * 0.3
    mask = rs.rand(n, h, w, 1).astype(np.float32) * 2 - 1
    want = jax.jit(_jax_extrapolate)(*map(jnp.asarray, (f0, f1, flow, mask)))
    got = warp.voxelflow_sample(_nchw(f0), _nchw(f1), torch.from_numpy(flow),
                                _nchw(mask), offsets=(-2.0, -1.0))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=PRED_ATOL)


@pytest.mark.parametrize("n", [1, 2, 37, 53, 64, 256, 448])
def test_linspace_is_jax_compiled_linspace_bit_for_bit(n):
    want = jax.jit(lambda x: x + jnp.linspace(-1.0, 1.0, n))(jnp.zeros(n))
    got = warp.linspace(n, torch.device("cpu"))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


CFG = dict(model="voxelflow", mode="val", optimizer="Adam", metasgd=True,
           loss="1*MSE", inner_lr=1e-5, crop_size=64)


@pytest.mark.parametrize("bn_flag", [False, True])
def test_inner_mask_matches_jax_with_and_without_bn_flag(bn_flag):
    cfg = dict(CFG, enable_inner_loop_optimizable_bn_params=bn_flag)
    jsys = JaxSystem(JaxConfig(**cfg))
    tsys = SceneAdaptiveInterpolation(Config(**cfg, device="cpu"))
    jmask = bridge.params_from_jax(jax.tree.map(
        lambda m, p: np.full(p.shape, m), jsys.inner_mask,
        jsys.meta_params["net"]), tsys.model)
    keep = tsys.builder.inner_keep
    assert set(keep) == set(tsys.meta_params["net"])
    assert keep == {k: bool(jmask[k].all()) for k in keep}
    assert keep["conv1.weight"] and keep["conv4.bias"]
    assert keep["deconv2_bn.weight"] == keep["conv1_bn.bias"] == bn_flag


def test_bn_statistics_are_not_meta_parameters():
    tsys = SceneAdaptiveInterpolation(Config(**CFG, device="cpu"))
    net = tsys.meta_params["net"]
    assert not any("running" in k for k in net)
    assert set(net) == set(tsys.meta_params["lrs"]) == {
        k for k, _ in tsys.model.named_parameters()}
    assert "conv3_bn.weight" in net and "conv3_bn.bias" in net
    # loading weights reaches the buffers, which the forward reads
    state = {k: v.clone() for k, v in tsys.model.state_dict().items()}
    state["conv1_bn.running_var"].fill_(4.0)
    tsys.load_net(state)
    assert float(tsys.model.conv1_bn.running_var[0]) == 4.0


def test_registry_builds_voxelflow_with_its_normalization():
    md = registry.get("VoxelFlow")
    assert not md.returns_aux and md.trainable     # meta-trains too
    m = md.build(None, warp_range=8)
    assert isinstance(m, VoxelFlow) and m.warp_range == 8
    assert md.build(None).warp_range is None
    jmd = jax_registry.get("voxelflow")
    x = np.random.RandomState(0).rand(4, 5, 3).astype(np.float32)
    np.testing.assert_allclose(md.normalize(x), np.asarray(jmd.normalize(x)),
                               atol=1e-7)
    y = torch.from_numpy(md.normalize(x).transpose(2, 0, 1))[None]
    np.testing.assert_allclose(md.denormalize(y)[0].numpy().transpose(1, 2, 0),
                               x, atol=1e-6)
    # a true division, as the CPU's by a scalar (CUDA's by a scalar is a
    # product with the reciprocal)
    assert torch.equal(md.denormalize(y), (y * 127.5 + 127.5) / 255.0)
    assert not torch.equal(md.denormalize(y),
                           (y * 127.5 + 127.5) * (1.0 / 255.0))
    w = m.conv2.weight.detach()
    assert abs(float(w.std()) - 0.01) < 5e-4 and abs(float(w.mean())) < 5e-4
    assert float(m.conv4.bias.detach().abs().max()) == 0.0
    with pytest.raises(ValueError, match="syn_type"):
        VoxelFlow(syn_type="both")
