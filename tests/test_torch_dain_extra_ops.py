"""DAIN's off-path ops in the port held against the JAX package's on the
CPU, value and gradient: the adaptive-weight splatting layers
(ops/adaptive_weight.py), the separable-convolution flow
(ops/sepconv.separable_conv_flow) and the min-depth flow projection
(ops/flow_projection.min_depth_flow_projection)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meta_interpolation_tpu.ops import adaptive_weight as jax_aw
from meta_interpolation_tpu.ops import flow_projection as jax_fp
from meta_interpolation_tpu.ops import sepconv as jax_sc
from meta_interpolation_tpu_torch.ops import adaptive_weight as aw
from meta_interpolation_tpu_torch.ops import flow_projection as fp
from meta_interpolation_tpu_torch.ops import sepconv as sc

# values and gradients: float32 in another summation order, relative to
# the largest value
TOL = 1e-5
N, H, W = 2, 9, 11


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(seed):
    rs = np.random.RandomState(seed)
    img1 = rs.rand(N, H, W, 3).astype(np.float32)
    img2 = rs.rand(N, H, W, 3).astype(np.float32)
    # flows of a few pixels, some landing off the frame; none on a whole
    # pixel, where a floor would flip between the two sides
    f1 = (rs.randn(N, H, W, 2) * 2.5 + 0.013).astype(np.float32)
    f2 = (rs.randn(N, H, W, 2) * 2.5 + 0.017).astype(np.float32)
    return img1, img2, f1, f2


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _close(got, want, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * max(1.0, np.abs(want).max()),
                               err_msg=what)


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def test_weight_layer_matches_jax():
    img1, img2, f1, _ = _inputs(0)
    want, vjp = jax.vjp(lambda a, f: jax_aw.weight_layer(a, jnp.asarray(
        img2), f), jnp.asarray(img1), jnp.asarray(f1))
    g = np.random.RandomState(9).rand(*want.shape).astype(np.float32)
    want_ga, want_gf = vjp(jnp.asarray(g))
    a, f = _nchw(img1).requires_grad_(), torch.tensor(f1, requires_grad=True)
    got = aw.weight_layer(a, _nchw(img2), f)
    got.backward(_nchw(g))
    _close(_nhwc(got), want)
    _close(_nhwc(a.grad), want_ga, "img1")
    _close(f.grad.numpy(), want_gf, "flow")


@pytest.mark.parametrize("layer", ["value", "weight", "reliable"])
def test_splat_layers_match_jax(layer):
    img1, _, f1, _ = _inputs(1)
    fw = np.random.RandomState(2).rand(N, H, W, 1).astype(np.float32)

    def jax_fn(img, flow, w):
        if layer == "value":
            return jax_aw.pixel_value_layer(img, flow, w)
        if layer == "weight":
            return jax_aw.pixel_weight_layer(flow, w)
        return jax_aw.reliable_weight_layer(flow)

    def port_fn(img, flow, w):
        if layer == "value":
            return aw.pixel_value_layer(img, flow, w)
        if layer == "weight":
            return aw.pixel_weight_layer(flow, w)
        return aw.reliable_weight_layer(flow)

    want, vjp = jax.vjp(jax_fn, jnp.asarray(img1), jnp.asarray(f1),
                        jnp.asarray(fw))
    g = np.random.RandomState(3).rand(*want.shape).astype(np.float32)
    grads = vjp(jnp.asarray(g))
    img = _nchw(img1).requires_grad_()
    flow = torch.tensor(f1, requires_grad=True)
    w = _nchw(fw).requires_grad_()
    got = port_fn(img, flow, w)
    got.backward(_nchw(g))
    _close(_nhwc(got), want)
    for t, want_g, what in ((img, grads[0], "img"), (flow, grads[1], "flow"),
                            (w, grads[2], "weights")):
        mine = (t.grad if t.grad is not None else torch.zeros_like(t))
        mine = mine.numpy() if what == "flow" else _nhwc(mine)
        _close(mine, want_g, what)


@pytest.mark.parametrize("training", [False, True])
def test_adaptive_weight_interpolation_matches_jax(training):
    img1, img2, f1, f2 = _inputs(4)
    args = [jnp.asarray(x) for x in (img1, img2, f1, f2)]
    want, vjp = jax.vjp(lambda *a: jax_aw.adaptive_weight_interpolation(
        *a, training=training), *args)
    g = np.random.RandomState(5).rand(*want.shape).astype(np.float32)
    want_g = vjp(jnp.asarray(g))
    ts = [_nchw(img1).requires_grad_(), _nchw(img2).requires_grad_(),
          torch.tensor(f1, requires_grad=True),
          torch.tensor(f2, requires_grad=True)]
    got = aw.adaptive_weight_interpolation(*ts, training=training)
    got.backward(_nchw(g))
    _close(_nhwc(got), want)
    for i, t in enumerate(ts):
        mine = t.grad.numpy() if i >= 2 else _nhwc(t.grad)
        _close(mine, want_g[i], f"input {i}")


def test_separable_conv_flow_matches_jax():
    rs = np.random.RandomState(6)
    kv = rs.rand(N, H, W, 5).astype(np.float32)
    kh = rs.rand(N, H, W, 5).astype(np.float32)
    kv[0, 0, 0] = 0.0            # the −2000 sentinel
    kh[1, 2, 3] = 0.0
    want, vjp = jax.vjp(jax_sc.separable_conv_flow, jnp.asarray(kv),
                        jnp.asarray(kh))
    g = rs.rand(*want.shape).astype(np.float32)
    want_gv, want_gh = vjp(jnp.asarray(g))
    tv, th = _nchw(kv).requires_grad_(), _nchw(kh).requires_grad_()
    got = sc.separable_conv_flow(tv, th)
    got.backward(torch.from_numpy(g))
    assert got.shape == (N, H, W, 2)
    assert float(got[0, 0, 0, 1]) == -2000.0 == float(got[1, 2, 3, 0])
    _close(got.detach().numpy(), want)
    _close(_nhwc(tv.grad), want_gv, "kv")
    _close(_nhwc(th.grad), want_gh, "kh")


@pytest.mark.parametrize("fill_hole", [False, True])
def test_min_depth_flow_projection_matches_jax(fill_hole):
    """Random flows, plus a tie: two sources of equal depth landing in one
    cell share the average of their flows."""
    _, _, f1, _ = _inputs(7)
    depth = np.random.RandomState(8).rand(N, H, W, 1).astype(np.float32)
    f1[0, 4, 4] = (1.25, 0.5)            # lands in cell (4, 5)
    f1[0, 4, 5] = (0.25, 0.75)           # lands in cell (4, 5) too
    depth[0, 4, 4] = depth[0, 4, 5] = 2.0
    want, vjp = jax.vjp(lambda f: jax_fp.min_depth_flow_projection(
        f, jnp.asarray(depth), fill_hole), jnp.asarray(f1))
    g = np.random.RandomState(9).rand(*want.shape).astype(np.float32)
    (want_g,) = vjp(jnp.asarray(g))
    flow = torch.tensor(f1, requires_grad=True)
    d = torch.tensor(depth, requires_grad=True)
    got = fp.min_depth_flow_projection(flow, d, fill_hole)
    got.backward(torch.from_numpy(g))
    _close(got.detach().numpy(), want)
    np.testing.assert_allclose(got[0, 4, 5].detach().numpy(),
                               [-0.75, -0.625], atol=1e-6)
    _close(flow.grad.numpy(), want_g, "flow")
    assert d.grad is None or float(d.grad.abs().max()) == 0.0
