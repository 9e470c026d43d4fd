"""The port's correlation and filter interpolation (meta_interpolation_tpu_
torch/ops/correlation.py, ops/filter_interpolation.py) held against the JAX
package on the CPU. Images are NCHW in the port and NHWC in JAX; flows are
(N, H, W, 2) in both; the port's filters are (N, 16, H, W)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meta_interpolation_tpu.ops import correlation as jax_corr
from meta_interpolation_tpu.ops import filter_interpolation as jax_fi
from meta_interpolation_tpu_torch.ops import filter_interpolation as fi
from meta_interpolation_tpu_torch.ops.correlation import correlation


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


# float32, another summation order (a mean over C; a 16-tap sum)
ATOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4


def _t(x):
    """NHWC numpy → NCHW torch."""
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _np(t):
    """NCHW torch → NHWC numpy."""
    return t.detach().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("n,h,w,c,d", [(2, 9, 11, 16, 4), (1, 5, 7, 3, 2)])
def test_correlation_matches_jax(n, h, w, c, d):
    rs = np.random.RandomState(h)
    f1 = rs.randn(n, h, w, c).astype(np.float32)
    f2 = rs.randn(n, h, w, c).astype(np.float32)
    want = jax_corr.correlation(jnp.asarray(f1), jnp.asarray(f2), d)
    got = correlation(_t(f1), _t(f2), d)
    assert got.shape == (n, (2 * d + 1) ** 2, h, w)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)


def _fi_inputs(n=2, h=9, w=13, c=5, span=3.0, seed=11):
    """Flows up to ±span: some samples land outside (passed through), some
    have |f| ≥ W/2 or H/2 at this small size (passed through too)."""
    rs = np.random.RandomState(seed)
    img = rs.rand(n, h, w, c).astype(np.float32)
    flow = (rs.rand(n, h, w, 2) * 2 * span - span).astype(np.float32)
    filters = rs.rand(n, h, w, 16).astype(np.float32)
    return img, flow, filters


@pytest.mark.parametrize("span", [1.5, 6.0])
def test_filter_interpolation_matches_jax(span):
    img, flow, filters = _fi_inputs(span=span, seed=int(span * 2))
    want = jax_fi.filter_interpolation(jnp.asarray(img), jnp.asarray(flow),
                                       jnp.asarray(filters))
    got = fi.filter_interpolation(_t(img), torch.from_numpy(flow),
                                  _t(filters))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)


def test_filter_interpolation_slabs_equal_one_gather(monkeypatch):
    """Capping the window temporary at 2 channels (3 slabs of a 5-channel
    image) changes nothing."""
    img, flow, filters = _fi_inputs()
    args = (_t(img), torch.from_numpy(flow), _t(filters))
    whole = fi.filter_interpolation(*args)
    monkeypatch.setattr(fi, "WINDOW_SLAB_BYTES", 2 * 2 * 9 * 13 * 16 * 4)
    np.testing.assert_array_equal(fi.filter_interpolation(*args).numpy(),
                                  whole.numpy())


def test_filter_interpolation_gradients_match_jax():
    """All three gradients (image, flow, filters) of Σ g·out."""
    img, flow, filters = _fi_inputs(seed=13)
    g = np.random.RandomState(14).randn(*img.shape).astype(np.float32)

    def jax_loss(i, f, k):
        return jnp.sum(jax_fi.filter_interpolation(i, f, k) * jnp.asarray(g))

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(img), jnp.asarray(flow), jnp.asarray(filters))
    leaves = [_t(img).requires_grad_(), torch.from_numpy(flow).requires_grad_(),
              _t(filters).requires_grad_()]
    (fi.filter_interpolation(*leaves) * _t(g)).sum().backward()
    got = [_np(leaves[0].grad), leaves[1].grad.numpy(), _np(leaves[2].grad)]
    for name, a, b in zip(("image", "flow", "filters"), got, want):
        np.testing.assert_allclose(a, np.asarray(b), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=name)
