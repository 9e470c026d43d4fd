"""The port's flow projection (meta_interpolation_tpu_torch/ops/
flow_projection.py, ops/flow_projection_bounded.py) held against the JAX
package on the CPU.

On CPU tensors the K4 wrapper runs its plain version; the CUDA kernel it
stands for is held against the same plain version on the card by
chip_smoke.py. Inputs come from a numpy seed; flows are (N, H, W, 2) and
depths (N, H, W, 1) in both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meta_interpolation_tpu.ops import flow_projection as jax_fp
from meta_interpolation_tpu.ops.flow_projection_pallas import (
    flow_projection_bounded as pallas_bounded)
from meta_interpolation_tpu_torch.ops import flow_projection as fp
from meta_interpolation_tpu_torch.ops import flow_projection_bounded as fpb

# K4's plain version against the TPU kernel in interpret mode: the limits
# of tests/test_dain_ops.py:193 (float32, another summation order)
K4_ATOL, K4_RTOL = 2e-5, 1e-5
# the exact scatter: float32 sums of at most a few contributions a cell
ATOL, RTOL = 1e-5, 1e-5
R = 8


def _inputs(n, h, w, span, seed):
    rs = np.random.RandomState(seed)
    flow = (rs.rand(n, h, w, 2) * 2 * span - span).astype(np.float32)
    depth = (rs.rand(n, h, w, 1) + 0.3).astype(np.float32)
    return flow, depth


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.fixture(scope="module")
def jax_exact():
    return jax.jit(jax_fp.flow_projection, static_argnames="fill_hole")


@pytest.mark.parametrize("span", [6.0, 12.0], ids=["within_R", "past_R"])
@pytest.mark.parametrize("with_depth", [True, False])
def test_plain_k4_matches_pallas_interpret(span, with_depth):
    """(2, 16, 32), R = 8, flows in [−span, span]: past R the kernel drops
    the far sources, and the plain version must drop the same ones."""
    flow, depth = _inputs(2, 16, 32, span, seed=int(span) + with_depth)
    depth = depth if with_depth else None
    want_proj, want_cnt = pallas_bounded(_j(flow), _j(depth),
                                         max_displacement=R, interpret=True)
    got_proj, got_cnt = fpb.flow_projection_bounded(_t(flow), _t(depth), R)
    np.testing.assert_allclose(got_proj.numpy(), np.asarray(want_proj),
                               atol=K4_ATOL, rtol=K4_RTOL)
    np.testing.assert_allclose(got_cnt.numpy(), np.asarray(want_cnt),
                               atol=K4_ATOL, rtol=K4_RTOL)
    np.testing.assert_array_equal(got_cnt.numpy() > 0,
                                  np.asarray(want_cnt) > 0)
    if span > R:
        # the bound really dropped sources: the exact scatter differs
        exact, _ = fpb.project_ref(_t(flow), _t(depth))
        assert float((exact - got_proj).abs().max()) > 1e-3


@pytest.mark.parametrize("with_depth", [True, False])
@pytest.mark.parametrize("fill_hole", [False, True])
def test_exact_matches_jax(jax_exact, with_depth, fill_hole):
    """Ragged (2, 13, 19), flows past the frame so that some sources land
    outside and leave holes."""
    flow, depth = _inputs(2, 13, 19, 5.0, seed=3)
    depth = depth if with_depth else None
    want = jax_exact(_j(flow), _j(depth), fill_hole=fill_hole)
    got = fp.flow_projection(_t(flow), _t(depth), fill_hole=fill_hole)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_fill_holes_equals_jax_scan():
    """Bit for bit, on random hole patterns including all-hole rows and
    columns and fully valid frames, as tests/test_dain_ops.py pins the
    JAX package's two fills."""
    rng = np.random.RandomState(0)
    for density in (0.0, 0.3, 0.97, 1.0):
        cnt = ((rng.rand(2, 13, 17) < density)
               * (1 + rng.rand(2, 13, 17))).astype(np.float32)
        out = np.where(cnt[..., None] > 0, rng.randn(2, 13, 17, 2),
                       0.0).astype(np.float32)
        want = jax_fp._fill_holes_scan(jnp.asarray(out), jnp.asarray(cnt))
        got = fp.fill_holes(torch.from_numpy(out), torch.from_numpy(cnt))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("proj_range", [None, R])
def test_gradient_matches_jax(proj_range):
    """d/d(flow, depth) of Σ g·flow_projection(fill_hole=True): the exact
    scatter's VJP on both paths (the fill carries no gradient). The JAX
    package takes its scatter on the CPU either way; its bounded path's
    custom VJP is that same scatter VJP."""
    flow, depth = _inputs(1, 12, 16, 4.0, seed=5)
    g = np.random.RandomState(6).randn(1, 12, 16, 2).astype(np.float32)

    def jax_loss(f, d):
        return jnp.sum(jax_fp.flow_projection(f, d, fill_hole=True)
                       * jnp.asarray(g))

    want = jax.grad(jax_loss, argnums=(0, 1))(_j(flow), _j(depth))
    f_t = torch.from_numpy(flow).requires_grad_()
    d_t = torch.from_numpy(depth).requires_grad_()
    out = fp.flow_projection(f_t, d_t, fill_hole=True, proj_range=proj_range)
    (out * torch.from_numpy(g)).sum().backward()
    for got, w in zip((f_t.grad, d_t.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=1e-4)


def test_cpu_dispatch_takes_the_plain_version():
    """proj_range on a CPU tensor runs K4's plain version (window mask
    included), never the exact scatter, and counts no launch."""
    flow, depth = _inputs(1, 16, 24, 12.0, seed=7)
    fpb.reset_launches()
    got = fp.flow_projection(_t(flow), _t(depth), proj_range=R)
    want, _ = fpb.project_ref(_t(flow), _t(depth), R)
    exact, _ = fpb.project_ref(_t(flow), _t(depth))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert float((exact - got).abs().max()) > 1e-3
    assert fpb.flow_projection_bounded.launches == 0

