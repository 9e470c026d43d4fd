"""The port's DAIN (meta_interpolation_tpu_torch/models/dain/) held against
the JAX package on the CPU, with the JAX init bridged into the port by
name and module type.

The random-init hourglass makes unbounded log depth, so both sides tame
its head as tests/test_dain_model.py does. The composed forward runs in
float64 on both sides, as tests/test_torch_parity_ext.py:812-816 does: in
float32, flows within ~1e-6 of a cell boundary take other floors in the
projection and the filter interpolation under another summation order,
and a few percent of pixels then differ by far more than rounding.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meta_interpolation_tpu.models.dain import hourglass as jax_hourglass
from meta_interpolation_tpu.models.dain import model as jax_dain
from meta_interpolation_tpu.models.dain import mononet as jax_mononet
from meta_interpolation_tpu.models.dain import pwcnet as jax_pwcnet
from meta_interpolation_tpu.models.dain import rectify as jax_rectify
from meta_interpolation_tpu.models.dain import s2df as jax_s2df
from meta_interpolation_tpu_torch.core import checkpoint as bridge
from meta_interpolation_tpu_torch.models import registry
from meta_interpolation_tpu_torch.models.dain import model as dain
from meta_interpolation_tpu_torch.models.dain.model import DAIN

N_LEAVES, N_VALUES = 797, 24_045_734
HW = (64, 64)
# float32 subnets: convolutions in another summation order, relative to
# the output's largest magnitude (the random-init hourglass runs large)
SUB_RTOL = 1e-5
# float64 composition: rounding only
F64_ATOL = 1e-9
R = 8


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
def model(jax_params):
    m = DAIN()
    m.load_state_dict(bridge.params_from_jax(jax_params, m))
    return m


@contextlib.contextmanager
def _x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _np(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _frames(seed, hw=HW, dtype=np.float32):
    rs = np.random.RandomState(seed)
    return [rs.rand(1, *hw, 3).astype(dtype) for _ in range(2)]


def _close(got, want, rtol=SUB_RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * float(np.abs(want).max()))


def test_bridge_names_and_shapes_match_model(jax_params):
    m = DAIN()
    state = bridge.params_from_jax(jax_params, m)   # checks names, shapes
    assert len(state) == N_LEAVES
    assert sum(v.numel() for v in state.values()) == N_VALUES
    for name in ("depthNet.0.weight", "depthNet.1.running_var",
                 "depthNet.1.weight", "flownets.deconv6.weight",
                 "flownets.upfeat3.weight", "flownets.predict_flow2.bias",
                 "flownets.conv6_4.0.weight", "flownets.dc_conv7.weight",
                 "initScaleNets_filter.32.weight",
                 "initScaleNets_filter2.2.bias", "ctxNet.block3.conv2.weight",
                 "rectifyNet.block4.conv1.weight"):
        assert name in state, name


def test_bridge_round_trip_and_layouts(jax_params):
    """JAX → port → JAX is the identity; a 2→2 transposed conv takes the
    (kh, kw, in, out) → (in, out, kh, kw) rule, not the conv rule, and
    batch-norm statistics land in the running buffers."""
    m = DAIN()
    state = bridge.params_from_jax(jax_params, m)
    k = jax_params["flownets"]["deconv6"]["kernel"]         # (4, 4, 2, 2)
    np.testing.assert_array_equal(state["flownets.deconv6.weight"].numpy(),
                                  k.transpose(2, 3, 0, 1))
    assert not np.array_equal(k.transpose(2, 3, 0, 1), k.transpose(3, 2, 0, 1))
    bn = jax_params["depthNet"]["1"]
    np.testing.assert_array_equal(state["depthNet.1.running_mean"].numpy(),
                                  bn["mean"])
    np.testing.assert_array_equal(state["depthNet.1.weight"].numpy(),
                                  bn["scale"])
    back = bridge.params_to_jax(state, m)
    flat = lambda t: dict(jax.tree_util.tree_leaves_with_path(t))
    want, got = flat(jax_params), flat(back)
    assert set(got) == set(want)
    for path, value in want.items():
        np.testing.assert_array_equal(got[path], value)


def test_bridge_refuses_a_tree_of_another_model(jax_params):
    with pytest.raises(ValueError, match="does not match"):
        bridge.params_from_jax({"rectifyNet": jax_params["rectifyNet"]},
                               DAIN())


@pytest.mark.parametrize("subnet", ["depthNet", "ctxNet", "filters",
                                    "flownets", "rectifyNet"])
def test_subnet_matches_jax(jax_params, model, subnet):
    f0, f1 = _frames(seed=3)
    with torch.no_grad():
        if subnet == "depthNet":
            want = jax.jit(jax_hourglass.apply)(jax_params["depthNet"], f0)
            _close(_np(model.depthNet(_t(f0))), want)
        elif subnet == "ctxNet":
            want = jax.jit(jax_s2df.apply)(jax_params["ctxNet"], f0)
            _close(_np(model.ctxNet(_t(f0))), want)
        elif subnet == "filters":
            want = jax.jit(jax_mononet.apply)(
                jax_params, np.concatenate([f0, f1], -1))
            temp = model.initScaleNets_filter(torch.cat([_t(f0), _t(f1)], 1))
            _close(_np(model.initScaleNets_filter1(temp)), want[0])
            _close(_np(model.initScaleNets_filter2(temp)), want[1])
        elif subnet == "flownets":
            want = jax.jit(jax_pwcnet.apply)(jax_params["flownets"], f0, f1)
            _close(_np(model.flownets(_t(f0), _t(f1))), want)
        else:
            x = np.random.RandomState(4).rand(1, 32, 32, 437).astype(
                np.float32)
            want = jax.jit(jax_rectify.apply)(jax_params["rectifyNet"], x)
            _close(_np(model.rectifyNet(_t(x))), want)


@pytest.fixture(scope="module")
def float64_reference(jax_params):
    """The JAX composed forward in float64, fill_holes=True (JAX on the
    CPU projects exactly whatever proj_range says)."""
    f0, f1 = _frames(seed=12, dtype=np.float64)
    with _x64():
        params = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64),
                              jax_params)
        apply = jax.jit(lambda p, a, b: jax_dain.apply(p, a, b,
                                                       fill_holes=True))
        want = np.asarray(apply(params, jnp.asarray(f0), jnp.asarray(f1)))
    return f0, f1, want


@pytest.fixture(scope="module")
def float64_port(jax_params, float64_reference):
    """The port's model in float64, and its flows on the reference frames."""
    f0, f1, _ = float64_reference
    m = DAIN()
    m.load_state_dict(bridge.params_from_jax(jax_params, m))
    m.double()
    with torch.no_grad():
        flows = m.flows(_t(f0), _t(f1))
    return m, max(float(f.abs().max()) for f in flows)


@pytest.mark.parametrize("proj_range", [None, R])
def test_composed_forward_float64_matches_jax(float64_port, float64_reference,
                                              proj_range):
    f0, f1, want = float64_reference
    m, flow_max = float64_port
    with torch.no_grad():
        got = m(_t(f0), _t(f1), proj_range=proj_range, fill_holes=True)
    # within R the bounded projection drops nothing, so both equal JAX
    assert flow_max < R - 1
    assert got.shape == (1, 3) + HW and got.dtype == torch.float64
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=F64_ATOL)


def test_registry_builds_dain():
    md = registry.get("DAIN")
    assert md.meta_apply_kwargs == {"fill_holes": True}
    assert md.inner_mask_fn is dain.inner_mask
    m = md.build(None)
    mask = md.inner_mask_fn(m)
    assert isinstance(m, DAIN)
    assert {k for k, v in mask.items() if v} == {
        k for k in mask if k.startswith("rectifyNet.")}
    assert sum(mask.values()) == 10
    # the meta system's loss is charbonnier whatever --loss says
    pred, target = (torch.from_numpy(f) for f in _frames(seed=7))
    losses = md.loss_fn(pred, target)
    assert set(losses) == {"DAIN", "total"}
    torch.testing.assert_close(losses["total"],
                               dain.charbonnier_loss(pred, target))


def test_forward_turns_tf32_off(float64_port, float64_reference):
    """A served forward computes in full float32 on the card: the forward
    itself turns cuDNN's and cuBLAS's TF32 off, with no system around it."""
    f0, f1, _ = float64_reference
    m, _ = float64_port
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with torch.no_grad():
            m(_t(f0), _t(f1))
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


def test_charbonnier_matches_jax():
    a, b = _frames(seed=5)
    want = jax_dain.charbonnier_loss(jnp.asarray(a), jnp.asarray(b))
    got = dain.charbonnier_loss(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_eval_batch_norm_ignores_train_mode(model):
    """The depth net normalises with its stored statistics even in train
    mode, where a stock nn.BatchNorm2d would use the batch's."""
    f0, _ = _frames(seed=6, hw=(32, 32))
    with torch.no_grad():
        model.eval()
        a = model.depthNet(_t(f0))
        model.train()
        b = model.depthNet(_t(f0))
        model.eval()
    np.testing.assert_array_equal(a.numpy(), b.numpy())
