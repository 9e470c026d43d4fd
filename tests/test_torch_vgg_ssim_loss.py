"""The port's SSIM and VGG19 perceptual losses (core/losses.py) held
against the JAX package's on the CPU: DSSIM's value and gradient in [0, 1]
and in mean-shifted space, VGG19 features at every cut and VGGP's four,
the perceptual losses' values and gradients, the VGG19 bridge and the
torchvision ``.pth`` it reads, and the random-init fallback."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meta_interpolation_tpu.core import losses as jax_losses
from meta_interpolation_tpu_torch.core import checkpoint as bridge
from meta_interpolation_tpu_torch.core import losses

# DSSIM: value and gradient (float32 sums in other orders)
SSIM_TOL = 1e-5
# VGG features and losses, relative to the largest value: 16 convolutions
# summed in other orders
VGG_RTOL = 1e-4
HW = 32


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_vgg19():
    return jax.tree.map(np.asarray, jax_losses.init_vgg19_params(
        jax.random.PRNGKey(3), max_cut=35))


@pytest.fixture(scope="module")
def port_vgg19(jax_vgg19):
    return bridge.vgg19_params_from_jax(jax_vgg19)


def _pair(seed, shift=0.0):
    rs = np.random.RandomState(seed)
    a = rs.rand(2, HW, HW, 3).astype(np.float32) - shift
    b = np.clip(a + 0.1 * rs.randn(*a.shape), -shift, 1 - shift).astype(
        np.float32)
    return a, b


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("space", ["unit", "mean_shifted"])
def test_dssim_value_and_gradient_match_jax(space):
    """[0, 1] (range 1) and mean-shifted [−0.5, 0.5] with values below
    −0.5 (the detected range is 2): value and gradient to SSIM_TOL."""
    shift = 0.0 if space == "unit" else 0.6
    a, b = _pair(0, shift)
    want, want_g = jax.value_and_grad(jax_losses.dssim_loss)(
        jnp.asarray(a), jnp.asarray(b))
    pred = _nchw(a).requires_grad_()
    got = losses.dssim_loss(pred, _nchw(b))
    got.backward()
    np.testing.assert_allclose(float(got), float(want), atol=SSIM_TOL)
    np.testing.assert_allclose(_nhwc(pred.grad), np.asarray(want_g),
                               atol=SSIM_TOL * np.abs(want_g).max())
    fn = losses.make_loss_fn("2*SSIM")
    np.testing.assert_allclose(float(fn(_nchw(a), _nchw(b))["SSIM"]),
                               2 * float(want), atol=2 * SSIM_TOL)


@pytest.mark.parametrize("cut", [8, 16, 26, 35])
def test_vgg19_features_match_jax(jax_vgg19, port_vgg19, cut):
    a, _ = _pair(1)
    want = np.asarray(jax_losses.vgg19_features(jax_vgg19, jnp.asarray(a),
                                                cut))
    got = _nhwc(losses.vgg19_features(port_vgg19, _nchw(a), cut))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want,
                               atol=VGG_RTOL * np.abs(want).max())


def test_vggp_collects_the_four_cuts(jax_vgg19, port_vgg19):
    a, _ = _pair(2)
    cuts = [8, 16, 26, 35]
    want = jax_losses.vgg19_features(jax_vgg19, jnp.asarray(a), 35,
                                     collect=cuts)
    got = losses.vgg19_features(port_vgg19, _nchw(a), 35, collect=cuts)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(_nhwc(g), w,
                                   atol=VGG_RTOL * np.abs(w).max())


@pytest.mark.parametrize("index", ["22", "P"])
def test_perceptual_loss_value_and_gradient_match_jax(jax_vgg19, port_vgg19,
                                                      index):
    a, b = _pair(3)

    def jax_loss(p):
        return jax_losses.vgg_perceptual_loss(jax_vgg19, p, jnp.asarray(b),
                                              index)

    want, want_g = jax.value_and_grad(jax_loss)(jnp.asarray(a))
    pred = _nchw(a).requires_grad_()
    target = _nchw(b).requires_grad_()
    got = losses.vgg_perceptual_loss(port_vgg19, pred, target, index)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=VGG_RTOL)
    want_g = np.asarray(want_g)
    np.testing.assert_allclose(_nhwc(pred.grad), want_g,
                               atol=VGG_RTOL * np.abs(want_g).max())
    # the target's features are constants
    assert target.grad is None
    spec = f"1*L1+0.1*VGG{index}"
    jfn = jax_losses.make_loss_fn(spec, vgg19_params=jax_vgg19)
    tfn = losses.make_loss_fn(spec, vgg19_params=port_vgg19)
    jout = jfn(jnp.asarray(a), jnp.asarray(b))
    tout = tfn(_nchw(a), _nchw(b))
    assert set(tout) == set(jout) == {"L1", f"VGG{index}", "total"}
    for key in tout:
        np.testing.assert_allclose(float(tout[key]), float(jout[key]),
                                   rtol=VGG_RTOL, err_msg=key)


def test_vgg19_bridge_and_pth_round_trip(jax_vgg19, port_vgg19, tmp_path):
    """A torchvision vgg19().features state dict saved as .pth loads as
    JAX's load_vgg19_from_torch_state reads it; the file is removed once
    read."""
    shapes = losses.vgg_shapes(losses.VGG19_LAYERS)
    assert list(shapes) == [f"conv_{i}" for i in range(16)]
    back = bridge.vgg19_params_to_jax(port_vgg19)
    for name in shapes:
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(back[name][leaf],
                                          jax_vgg19[name][leaf])
    # a stack cut short bridges its convs; a gap does not
    short = {f"conv_{i}": jax_vgg19[f"conv_{i}"] for i in range(4)}
    assert sorted(bridge.vgg19_params_from_jax(short)) == sorted(short)
    with pytest.raises(ValueError, match="names"):
        bridge.vgg19_params_from_jax({"conv_1": jax_vgg19["conv_1"]})
    state, conv_i = {}, 0
    for idx, (kind, _) in enumerate(losses.VGG19_LAYERS):
        if kind == "conv":
            state[f"{idx}.weight"] = port_vgg19[f"conv_{conv_i}"]["weight"]
            state[f"{idx}.bias"] = port_vgg19[f"conv_{conv_i}"]["bias"]
            conv_i += 1
    path = tmp_path / "vgg19_features.pth"
    torch.save(state, path)
    try:
        loaded = losses.load_vgg19_from_torch_state(
            bridge.load_torch_file(str(path)))
        want = jax_losses.load_vgg19_from_torch_state(
            {k: v.numpy() for k, v in torch.load(path).items()})
    finally:
        path.unlink()
    for name in shapes:
        np.testing.assert_array_equal(loaded[name]["weight"].numpy(),
                                      port_vgg19[name]["weight"].numpy())
        np.testing.assert_array_equal(
            np.asarray(want[name]["kernel"]),
            loaded[name]["weight"].numpy().transpose(2, 3, 1, 0))


def test_vgg19_fallback_warns_and_cuts_to_the_deepest_term(monkeypatch,
                                                           tmp_path, capsys):
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv(losses.VGG_WEIGHTS_ENV, raising=False)
    fn = losses.make_loss_fn("1*VGG22+1*VGG44",
                             generator=torch.Generator().manual_seed(0))
    err = capsys.readouterr().err
    assert "WARNING: no pretrained vgg19 weights found" in err
    assert "vgg19_features.pth" in err
    # He init to module 26: the convs of VGG44's cut
    assert len(fn.vgg19_params) == 12 and fn.vgg16_params is None
    w = fn.vgg19_params["conv_11"]["weight"]
    assert abs(float(w.std()) / (2.0 / (512 * 9)) ** 0.5 - 1) < 0.02
    assert len(losses.make_loss_fn("1*VGGP").vgg19_params) == 16
    # a found file is read, on the search path of the VGG16 weights
    weights = tmp_path / "weights"
    weights.mkdir()
    monkeypatch.setenv(losses.VGG_WEIGHTS_ENV, str(weights))
    state = {"0.weight": torch.ones(64, 3, 3, 3), "0.bias": torch.zeros(64)}
    torch.save(state, weights / "vgg19_features.pth")
    try:
        fn = losses.make_loss_fn("1*VGG22")
    finally:
        (weights / "vgg19_features.pth").unlink()
    assert "loaded pretrained vgg19" in capsys.readouterr().out
    assert list(fn.vgg19_params) == ["conv_0"]
    with pytest.raises(ValueError, match="VGG99"):
        losses.make_loss_fn("1*VGG99")
