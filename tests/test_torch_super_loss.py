"""The port's Super loss, VGG16 features and FlowStats
(meta_interpolation_tpu_torch/core/losses.py, ops/warp.py) held against the
JAX package on the CPU, with JAX's VGG16 params bridged into the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meta_interpolation_tpu.core import losses as jax_losses
from meta_interpolation_tpu.ops import warp as jax_warp
from meta_interpolation_tpu_torch.core import checkpoint as bridge
from meta_interpolation_tpu_torch.core import losses
from meta_interpolation_tpu_torch.ops import warp


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


# ten 3x3 convolutions in float32 on He-init weights: features of O(1-10)
FEAT_RTOL = 1e-5          # of the largest feature
LOSS_RTOL = 1e-5
HW = (64, 64)
# torchvision vgg16().features module indices of its ten convs to conv4_3
TORCHVISION_CONVS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21)


@pytest.fixture(scope="module")
def jax_vgg():
    return jax.tree.map(np.asarray, jax_losses.init_vgg16_params(
        jax.random.PRNGKey(4)))


@pytest.fixture(scope="module")
def port_vgg(jax_vgg):
    return bridge.vgg16_params_from_jax(jax_vgg)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _inputs(seed=0):
    """pred, target and the Super loss's aux, NHWC numpy: frames in
    model space (mean-subtracted), flows of a few pixels."""
    rs = np.random.RandomState(seed)
    frame = lambda: rs.rand(1, *HW, 3).astype(np.float32) - 0.42
    flow = lambda: (rs.randn(1, *HW, 2) * 3).astype(np.float32)
    pred, target = frame(), frame()
    aux = {"bidirectional_flow": (flow(), flow()),
           "warped_intermediate_frames": (frame(), frame()),
           "warped_input_frames": (frame(), frame()),
           "I0": frame(), "I1": frame()}
    return pred, target, aux


def _port_aux(aux):
    return {k: (tuple(map(_nchw, v)) if isinstance(v, tuple) else _nchw(v))
            for k, v in aux.items()}


def test_vgg16_bridge_names_and_shapes(jax_vgg, port_vgg):
    shapes = losses.vgg16_shapes()
    assert list(shapes) == [f"conv_{i}" for i in range(10)]
    for name, (w_shape, b_shape) in shapes.items():
        assert tuple(port_vgg[name]["weight"].shape) == w_shape
        assert tuple(port_vgg[name]["bias"].shape) == b_shape
    back = bridge.vgg16_params_to_jax(port_vgg)
    for name in shapes:
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(back[name][leaf],
                                          jax_vgg[name][leaf])
    with pytest.raises(ValueError, match="names"):
        bridge.vgg16_params_from_jax({"conv_0": jax_vgg["conv_0"]})


def test_vgg16_features_match_jax(jax_vgg, port_vgg):
    x, _, _ = _inputs()
    want = np.asarray(jax.jit(jax_losses.vgg16_features)(jax_vgg,
                                                         jnp.asarray(x)))
    got = losses.vgg16_features(port_vgg, _nchw(x))
    assert got.shape == (1, 512, 8, 8)
    got = got.numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, want, atol=FEAT_RTOL * np.abs(want).max())


def test_port_vgg16_init_is_he():
    params = losses.init_vgg16_params(torch.Generator().manual_seed(0))
    w = params["conv_8"]["weight"]          # 512 x 512 x 3 x 3
    assert abs(float(w.std()) / (2.0 / (512 * 9)) ** 0.5 - 1) < 0.01
    assert float(params["conv_8"]["bias"].abs().max()) == 0.0


@pytest.mark.parametrize("term", ["Super", "SuperNoPrcp"])
def test_loss_terms_match_jax(jax_vgg, port_vgg, term):
    pred, target, aux = _inputs(1)
    spec = f"1*{term}+0.5*L1"
    jfn = jax_losses.make_loss_fn(spec, vgg16_params=jax_vgg)
    want = jax.jit(jfn)(jnp.asarray(pred), jnp.asarray(target),
                        jax.tree.map(jnp.asarray, aux))
    fn = losses.make_loss_fn(spec, vgg16_params=port_vgg)
    assert (fn.vgg16_params is not None) == (term == "Super")
    got = fn(_nchw(pred), _nchw(target), _port_aux(aux))
    assert set(got) == set(want) == {term, "L1", "total"}
    for key in got:
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=LOSS_RTOL, err_msg=key)


def test_superslomo_loss_matches_jax_and_reads_the_perceptual_term(
        jax_vgg, port_vgg):
    pred, target, aux = _inputs(2)
    args = (_nchw(pred), _nchw(target), _port_aux(aux))
    with_vgg = losses.superslomo_loss(*args, port_vgg)
    without = losses.superslomo_loss(*args, None)
    want = jax_losses.superslomo_loss(
        jnp.asarray(pred), jnp.asarray(target),
        jax.tree.map(jnp.asarray, aux), jax_vgg)
    np.testing.assert_allclose(float(with_vgg), float(want), rtol=LOSS_RTOL)
    assert float(with_vgg) > float(without)


def test_super_loss_gradient_reaches_pred_and_flows(port_vgg):
    pred, target, aux = _inputs(3)
    pred = _nchw(pred).requires_grad_()
    aux = _port_aux(aux)
    flow = aux["bidirectional_flow"][0].requires_grad_()
    losses.superslomo_loss(pred, _nchw(target), aux, port_vgg).backward()
    assert float(pred.grad.abs().sum()) > 0
    assert float(flow.grad.abs().sum()) > 0


def test_pixel_terms_ignore_aux():
    pred, target, aux = _inputs(4)
    fn = losses.make_loss_fn("1*L1+2*MSE")
    assert fn.vgg16_params is None
    a = fn(_nchw(pred), _nchw(target))
    b = fn(_nchw(pred), _nchw(target), _port_aux(aux))
    assert float(a["total"]) == float(b["total"])
    # VGG22 is ported now (tests/test_torch_vgg_ssim_loss.py); an unknown
    # term raises
    with pytest.raises(ValueError, match="Bogus"):
        losses.make_loss_fn("1*Bogus")


def _isolate_search_path(monkeypatch, tmp_path):
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv(losses.VGG_WEIGHTS_ENV, raising=False)


def test_missing_weights_warn_and_fall_back_to_he_init(monkeypatch, tmp_path,
                                                       capsys):
    _isolate_search_path(monkeypatch, tmp_path)
    assert losses.find_pretrained_vgg("vgg16_features") is None
    fn = losses.make_loss_fn("1*Super",
                             generator=torch.Generator().manual_seed(0))
    err = capsys.readouterr().err
    assert "WARNING: no pretrained vgg16 weights found" in err
    assert "vgg16_features.pth" in err
    assert set(fn.vgg16_params) == set(losses.vgg16_shapes())
    # SuperNoPrcp needs no VGG weights and says nothing
    losses.make_loss_fn("1*SuperNoPrcp")
    assert "WARNING" not in capsys.readouterr().err


def test_found_weights_load_as_torchvision_state(monkeypatch, tmp_path,
                                                 capsys, jax_vgg):
    """A torchvision vgg16().features state dict on the search path loads
    directly, as JAX's load_vgg16_from_torch_state reads it."""
    _isolate_search_path(monkeypatch, tmp_path)
    weights = tmp_path / "weights"
    weights.mkdir()
    monkeypatch.setenv(losses.VGG_WEIGHTS_ENV, str(weights))
    port = bridge.vgg16_params_from_jax(jax_vgg)
    state = {}
    for i, idx in enumerate(TORCHVISION_CONVS):
        state[f"{idx}.weight"] = port[f"conv_{i}"]["weight"] + 0.5
        state[f"{idx}.bias"] = port[f"conv_{i}"]["bias"] + 0.25
    torch.save(state, weights / "vgg16_features.pth")
    fn = losses.make_loss_fn("1*Super")
    assert "loaded pretrained vgg16" in capsys.readouterr().out
    want = bridge.vgg16_params_from_jax(jax.tree.map(
        np.asarray, jax_losses.load_vgg16_from_torch_state(
            {k: v.numpy() for k, v in state.items()})))
    for name, p in want.items():
        for leaf in ("weight", "bias"):
            assert torch.equal(fn.vgg16_params[name][leaf], p[leaf])
    (weights / "vgg16_features.pth").unlink()


@pytest.mark.parametrize("align_corners", [False, True])
def test_flow_stats_match_jax(align_corners):
    """The same grid through JAX's eager grid_sample and the port's: the
    same share beyond R and the same largest displacement."""
    rs = np.random.RandomState(6)
    n, h, w, r = 2, 37, 53, 4
    img = rs.rand(n, h, w, 3).astype(np.float32)
    grid = (rs.rand(n, h, w, 2).astype(np.float32) * 2.4 - 1.2)
    with jax_warp.FlowStats(r=r) as jfs:
        jax_warp.grid_sample(jnp.asarray(img), jnp.asarray(grid),
                             align_corners=align_corners)
    with warp.FlowStats(r=r) as fs:
        warp.grid_sample(_nchw(img), torch.from_numpy(grid),
                         align_corners=align_corners)
    assert fs.calls == jfs.calls == 1
    assert (fs.n_beyond, fs.n_total) == (jfs.n_beyond, jfs.n_total)
    assert 0.1 < fs.frac_beyond < 1
    np.testing.assert_allclose(fs.max_disp, jfs.max_disp, rtol=1e-6)
    # outside the context nothing records
    warp.grid_sample(_nchw(img), torch.from_numpy(grid))
    assert fs.calls == 1
