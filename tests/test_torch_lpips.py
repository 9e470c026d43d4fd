"""The port's LPIPS (utils/lpips.py, utils/profiling.eval_lpips) held
against the JAX package's on the CPU, the weight loaders, and ``--lpips``
on the validation line."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meta_interpolation_tpu.utils import lpips as jax_lpips
from meta_interpolation_tpu.utils import profiling as jax_profiling
from meta_interpolation_tpu_torch.core import checkpoint as bridge
from meta_interpolation_tpu_torch.utils import lpips, profiling

# a distance per batch element, float32 convolutions summed in other
# orders
LPIPS_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def params():
    jp = jax.tree.map(np.asarray, jax_lpips.init_params(
        jax.random.PRNGKey(0)))
    return jp, bridge.lpips_params_from_jax(jp)


def _images(seed, hw=(64, 80)):
    rs = np.random.RandomState(seed)
    a = rs.rand(2, *hw, 3).astype(np.float32)
    b = np.clip(a + 0.2 * rs.randn(*a.shape), 0, 1).astype(np.float32)
    return a, b


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("hw", [(64, 80), (32, 32)])
def test_lpips_matches_jax(params, hw):
    jp, tp = params
    a, b = _images(0, hw)
    want = np.asarray(jax_lpips.lpips(jp, jnp.asarray(a), jnp.asarray(b)))
    got = lpips.lpips(tp, _nchw(a), _nchw(b))
    assert got.shape == (2,)
    np.testing.assert_allclose(got.numpy(), want, atol=LPIPS_TOL)
    assert float(lpips.lpips(tp, _nchw(a), _nchw(a)).abs().max()) == 0.0


def test_eval_lpips_matches_jax_and_loads_once(params, monkeypatch):
    jp, tp = params
    a, b = _images(1)
    monkeypatch.setattr(jax_profiling, "_LPIPS_PARAMS", jp)
    want = jax_profiling.eval_lpips(a, b)
    loads = []
    monkeypatch.setattr(profiling, "_LPIPS_PARAMS", None)
    monkeypatch.setattr(profiling, "_LPIPS_ON", {})
    monkeypatch.setattr(lpips, "load_pretrained",
                        lambda: loads.append(1) or tp)
    got = profiling.eval_lpips(_nchw(a), _nchw(b))
    again = profiling.eval_lpips(_nchw(a), _nchw(b))
    assert loads == [1] and got == again
    np.testing.assert_allclose(got, want, atol=LPIPS_TOL)


def test_random_init_shapes_and_fallback(monkeypatch, tmp_path, capsys):
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("MIT_VGG_WEIGHTS", raising=False)
    assert lpips.load_pretrained() is None
    assert "LPIPS runs on RANDOM-INIT" in capsys.readouterr().err
    p = lpips.init_params(torch.Generator().manual_seed(0))
    for name, (w, b) in lpips.alexnet_shapes().items():
        assert tuple(p["convs"][name]["weight"].shape) == w
    assert [tuple(v.shape) for v in p["lins"].values()] == [
        (c,) for c in lpips.LIN_CHANNELS]
    assert all(float(v.min()) >= 0 for v in p["lins"].values())


def test_loaders_read_torch_states_and_refuse_missing_lins(params, tmp_path,
                                                           monkeypatch,
                                                           capsys):
    jp, tp = params
    state, conv_i = {}, 0
    for idx, (kind, *_r) in enumerate(lpips.ALEX_LAYERS):
        if kind == "conv":
            state[f"{idx}.weight"] = tp["convs"][str(conv_i)]["weight"]
            state[f"{idx}.bias"] = tp["convs"][str(conv_i)]["bias"]
            conv_i += 1
    convs = lpips.load_alexnet_from_torch_state(state)
    want = jax_lpips.load_alexnet_from_torch_state(
        {k: v.numpy() for k, v in state.items()})
    for name, c in convs.items():
        np.testing.assert_array_equal(
            c["weight"].numpy().transpose(2, 3, 1, 0),
            np.asarray(want[name]["kernel"]))
    lin_state = {f"lin{i}.model.1.weight": v.reshape(1, -1, 1, 1)
                 for i, v in tp["lins"].items()}
    lins = lpips.load_lins_from_torch_state(lin_state)
    for i, v in lins.items():
        np.testing.assert_array_equal(v.numpy(), tp["lins"][i].numpy())
    partial = {k: v for k, v in lin_state.items() if not k.startswith("lin3")}
    with pytest.raises(ValueError, match=r"layers \[3\]"):
        lpips.load_lins_from_torch_state(partial)
    with pytest.raises(ValueError, match=r"layers \[3\]"):
        jax_lpips.load_lins_from_torch_state(
            {k: v.numpy() for k, v in partial.items()})
    # on the search path: an unusable lins file falls back, a good one
    # loads
    monkeypatch.setenv("MIT_VGG_WEIGHTS", str(tmp_path))
    torch.save(state, tmp_path / "alexnet_features.pth")
    torch.save(partial, tmp_path / "lpips_alex_lins.pth")
    assert lpips.load_pretrained() is None
    assert "unusable" in capsys.readouterr().err
    torch.save(lin_state, tmp_path / "lpips_alex_lins.pth")
    loaded = lpips.load_pretrained()
    for path in tmp_path.glob("*.pth"):
        path.unlink()
    a, b = _images(2)
    np.testing.assert_array_equal(lpips.lpips(loaded, _nchw(a), _nchw(b)),
                                  lpips.lpips(tp, _nchw(a), _nchw(b)))
