"""The port's SepConv model, layers and weight bridge held against the JAX
package on the CPU (meta_interpolation_tpu_torch/models/,
meta_interpolation_tpu_torch/core/checkpoint.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meta_interpolation_tpu.models import layers as jax_layers
from meta_interpolation_tpu.models import sepconv as jax_sepconv
from meta_interpolation_tpu_torch.core import checkpoint as bridge
from meta_interpolation_tpu_torch.models import layers
from meta_interpolation_tpu_torch.models import registry
from meta_interpolation_tpu_torch.models.sepconv import SepConv, inner_mask


pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def one_thread():
    """One intra-op thread while this file runs: the tier-1 run puts six
    test files side by side on one host, and a thread per core each slows
    every file down."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


LAYER_ATOL = 1e-6   # one resampling pass in float32
MODEL_ATOL = 1e-4   # ~30 convolutions and two F=51 sepconvs in float32


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree.map(np.asarray, jax_sepconv.init(jax.random.PRNGKey(0)))


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def test_bridge_round_trip_and_names_match_model(jax_params):
    state = bridge.params_from_jax(jax_params, SepConv())
    model_state = SepConv().state_dict()
    assert set(state) == set(model_state)
    for name, value in state.items():
        assert value.shape == model_state[name].shape, name
    assert "moduleConv1.0.weight" in state
    assert "moduleUpsample5.1.weight" in state
    assert "moduleVertical1.7.weight" in state
    back = bridge.params_to_jax(state, SepConv())
    flat_a = jax.tree_util.tree_flatten_with_path(jax_params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, value in flat_a:
        np.testing.assert_array_equal(flat_b[path], value)


def test_import_pth_loads_reference_names_and_skips_mismatches(tmp_path,
                                                              jax_params):
    state = bridge.params_from_jax(jax_params, SepConv())
    saved = {f"module.{k}": v for k, v in state.items()}
    saved["moduleConv1.0.bias"] = torch.zeros(7)      # wrong shape: skipped
    saved["unrelated.weight"] = torch.zeros(3)        # unknown: ignored
    path = tmp_path / "ref.pth"
    torch.save({"state_dict": saved}, path)
    model = SepConv()
    merged, loaded = bridge.import_pth(str(path), model.state_dict())
    model.load_state_dict(merged)
    assert not loaded["moduleConv1.0.bias"]
    assert sum(loaded.values()) == len(state) - 1
    for name, value in model.state_dict().items():
        if loaded[name]:
            torch.testing.assert_close(value, state[name], rtol=0, atol=0)
    path.unlink()


def test_port_init_is_xavier_with_zero_bias():
    model = SepConv(torch.Generator().manual_seed(0))
    w = model.moduleConv2[0].weight.detach()
    bound = np.sqrt(6.0 / ((32 + 64) * 9))
    assert float(w.abs().max()) <= bound
    assert float(w.abs().max()) > 0.9 * bound
    assert float(model.moduleConv2[0].bias.detach().abs().max()) == 0.0
    again = SepConv(torch.Generator().manual_seed(0))
    torch.testing.assert_close(again.moduleConv2[0].weight, w, rtol=0,
                               atol=0)


def test_inner_mask_matches_jax(jax_params):
    mask = inner_mask(SepConv())
    # the JAX mask has a scalar per leaf: broadcast it to the leaf's shape
    # so it bridges by name like the parameters
    jmask = bridge.params_from_jax(jax.tree.map(
        lambda m, p: np.full(p.shape, m), jax_sepconv.inner_mask(jax_params),
        jax_params), SepConv())
    assert {k: bool(v.all()) for k, v in jmask.items()} == mask
    assert not mask["moduleVertical1.0.weight"]
    assert mask["moduleConv1.0.weight"]


@pytest.mark.parametrize("pad", [3, (1, 2, 3, 4)])
def test_replicate_pad_matches_jax(pad):
    x = np.random.RandomState(0).rand(2, 5, 6, 3).astype(np.float32)
    want = jax_layers.replicate_pad(jnp.asarray(x), pad)
    got = layers.replicate_pad(_nchw(x), pad)
    np.testing.assert_array_equal(_nhwc(got), np.asarray(want))


def test_avg_pool_matches_jax():
    x = np.random.RandomState(1).rand(2, 8, 6, 4).astype(np.float32)
    want = jax_layers.avg_pool(jnp.asarray(x), 2)
    got = layers.avg_pool(_nchw(x), 2)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=LAYER_ATOL)


@pytest.mark.parametrize("align_corners", [True, False])
def test_upsample_bilinear_matches_jax(align_corners):
    x = np.random.RandomState(2).rand(1, 5, 7, 3).astype(np.float32)
    want = jax_layers.upsample_bilinear(jnp.asarray(x), 2,
                                        align_corners=align_corners)
    got = layers.upsample_bilinear(_nchw(x), 2, align_corners=align_corners)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=LAYER_ATOL)


def test_full_width_forward_matches_jax(jax_params):
    """Full-width SepConv at 78×78 (pads to 128×128) with bridged weights
    against the JAX model on its plain sepconv path."""
    rs = np.random.RandomState(5)
    f0 = rs.rand(1, 78, 78, 3).astype(np.float32)
    f1 = rs.rand(1, 78, 78, 3).astype(np.float32)
    want = jax_sepconv.apply(jax_params, jnp.asarray(f0), jnp.asarray(f1),
                             use_pallas=False)
    model = SepConv()
    model.load_state_dict(bridge.params_from_jax(jax_params, model))
    with torch.no_grad():
        got = model(_nchw(f0), _nchw(f1))
    assert got.shape == (1, 3, 78, 78)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=MODEL_ATOL)


def test_registry_has_sepconv_and_names_the_rest_unported():
    md = registry.get("SepConv")
    assert md.tile_pixel_limit == 5e5
    assert isinstance(md.build(None), SepConv)
    # CAIN, the last backbone, is ported now; only unknown names raise
    assert registry.get("cain").name == "cain"
    with pytest.raises(NotImplementedError, match="not implemented"):
        registry.get("nosuchmodel")
