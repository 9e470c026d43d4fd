"""The port's warp ops (meta_interpolation_tpu_torch/ops/warp.py,
ops/warp_bounded.py) and reflect padding held against the JAX package on
the CPU.

On CPU tensors the port's wrappers run their plain PyTorch versions; the
CUDA kernels they stand for are held against the same plain versions on
the card by chip_smoke.py. Inputs come from a numpy seed; JAX images are
NHWC, the port's NCHW; coordinate planes are (N, H, W) and grids
(N, H, W, 2) in both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meta_interpolation_tpu.models import layers as jax_layers
from meta_interpolation_tpu.ops import warp as jax_warp
from meta_interpolation_tpu.ops import warp_pallas
from meta_interpolation_tpu_torch.models import layers
from meta_interpolation_tpu_torch.ops import warp
from meta_interpolation_tpu_torch.ops import warp_bounded as wb


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


# float32 with another summation order
ATOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5


def _t(x):
    """NHWC numpy → NCHW torch."""
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _np(t):
    """NCHW torch → NHWC numpy."""
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _coords(n, h, w, r, seed, lo=None, hi=None):
    """Floor displacements uniform over [lo, hi] (default the contract
    [−R, R−1]) and fractional parts in [0, 1)."""
    rs = np.random.RandomState(seed)
    lo = -r if lo is None else lo
    hi = r - 1 if hi is None else hi
    dy0 = rs.randint(lo, hi + 1, (n, h, w)).astype(np.int32)
    dx0 = rs.randint(lo, hi + 1, (n, h, w)).astype(np.int32)
    fy = rs.rand(n, h, w).astype(np.float32)
    fx = rs.rand(n, h, w).astype(np.float32)
    return dy0, dx0, fy, fx


def _torch_coords(*planes):
    return [torch.from_numpy(p) for p in planes]


# --- (a) K3's plain version -------------------------------------------------

def test_plain_forward_matches_pallas_interpret():
    """The TPU kernel in interpret mode at (1, 16, 128, 3), R = 4, as
    tests/test_fast_warp.py runs it."""
    r = 4
    img = np.random.RandomState(8).rand(1, 16, 128, 3).astype(np.float32)
    coords = _coords(1, 16, 128, r, seed=9)
    want = warp_pallas.warp_bounded_pallas(
        jnp.asarray(img), *map(jnp.asarray, coords), r, interpret=True)
    got = wb.warp_bounded_ref(_t(img), *_torch_coords(*coords), r)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("n,h,w,c,r,lo,hi", [
    (2, 13, 17, 3, 3, None, None),     # ragged, in the contract
    (1, 9, 11, 2, 2, -5, 4),           # floors beyond [−R, R−1]
])
def test_plain_forward_matches_xla_sweep(n, h, w, c, r, lo, hi):
    img = np.random.RandomState(h).rand(n, h, w, c).astype(np.float32)
    coords = _coords(n, h, w, r, seed=w, lo=lo, hi=hi)
    want = jax_warp._warp_bounded_xla(jnp.asarray(img),
                                      *map(jnp.asarray, coords), r)
    got = wb.warp_bounded_ref(_t(img), *_torch_coords(*coords), r)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)


def test_plain_forward_is_the_clamped_bilinear_tap():
    """In the contract the sweep is one edge-clamped 2×2 tap: the library
    sampler with border padding at (x+dx0+fx, y+dy0+fy) computes it."""
    n, h, w, c, r = 1, 12, 19, 3, 4
    img = _t(np.random.RandomState(1).rand(n, h, w, c).astype(np.float32))
    dy0, dx0, fy, fx = _torch_coords(*_coords(n, h, w, r, seed=2))
    xs = torch.arange(w)[None, None, :] + dx0 + fx
    ys = torch.arange(h)[None, :, None] + dy0 + fy
    grid = torch.stack([2 * xs / (w - 1) - 1, 2 * ys / (h - 1) - 1], -1)
    want = torch.nn.functional.grid_sample(
        img, grid, padding_mode="border", align_corners=True)
    got = wb.warp_bounded_ref(img, dy0, dx0, fy, fx, r)
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)


# --- (b) gradients ------------------------------------------------------------

def test_function_gradients_match_jax_vjp():
    n, h, w, c, r = 1, 10, 14, 3, 3
    rs = np.random.RandomState(3)
    img = rs.rand(n, h, w, c).astype(np.float32)
    g = rs.randn(n, h, w, c).astype(np.float32)
    dy0, dx0, fy, fx = _coords(n, h, w, r, seed=4)
    _, vjp = jax.vjp(lambda i, a, b: jax_warp._warp_bounded_xla(
        i, jnp.asarray(dy0), jnp.asarray(dx0), a, b, r),
        jnp.asarray(img), jnp.asarray(fy), jnp.asarray(fx))
    j_img, j_fy, j_fx = vjp(jnp.asarray(g))

    t_img = _t(img).requires_grad_()
    t_fy = torch.from_numpy(fy).requires_grad_()
    t_fx = torch.from_numpy(fx).requires_grad_()
    out = wb.WarpBoundedRef.apply(t_img, torch.from_numpy(dy0),
                                  torch.from_numpy(dx0), t_fy, t_fx, r)
    (out * _t(g)).sum().backward()
    for got, want, name in [(_np(t_img.grad), j_img, "gimg"),
                            (t_fy.grad.numpy(), j_fy, "gfy"),
                            (t_fx.grad.numpy(), j_fx, "gfx")]:
        np.testing.assert_allclose(got, np.asarray(want), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)


@pytest.mark.parametrize("lo,hi", [(None, None), (-6, 5)])
def test_plain_frac_gradient_matches_autograd_of_sweep(lo, hi):
    n, h, w, c, r = 2, 9, 13, 3, 4
    rs = np.random.RandomState(5)
    img = _t(rs.rand(n, h, w, c).astype(np.float32))
    g = _t(rs.randn(n, h, w, c).astype(np.float32))
    dy0, dx0, fy, fx = _torch_coords(*_coords(n, h, w, r, 6, lo, hi))
    fy.requires_grad_()
    fx.requires_grad_()
    (wb.warp_bounded_ref(img, dy0, dx0, fy, fx, r) * g).sum().backward()
    gfy, gfx = wb.warp_bounded_grad_frac_ref(img, dy0, dx0, fy.detach(),
                                             fx.detach(), g, r)
    torch.testing.assert_close(gfy, fy.grad, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    torch.testing.assert_close(gfx, fx.grad, rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("function", ["sweep", "sampler"])
def test_function_skips_the_image_gradient_when_not_needed(function):
    """The sweep's Function with only fy needing a gradient, and the
    sampler's (GridSampleBoundedFunction) with only the grid needing one:
    the image gets none."""
    n, h, w, c, r = 1, 6, 7, 3, 2
    img = _t(np.random.RandomState(7).rand(n, h, w, c).astype(np.float32))
    if function == "sweep":
        dy0, dx0, leaf, fx = _torch_coords(*_coords(n, h, w, r, seed=8))
        leaf.requires_grad_()
        wb.WarpBoundedRef.apply(img, dy0, dx0, leaf, fx, r).sum().backward()
        assert fx.grad is None
    else:
        leaf = torch.from_numpy(_grid(n, h, w, False, 3, seed=8))
        leaf.requires_grad_()
        wb.GridSampleBoundedFunction.apply(img, leaf, r, False, "zeros"
                                           ).sum().backward()
    assert img.grad is None
    assert torch.isfinite(leaf.grad).all() and leaf.grad.abs().sum() > 0


def test_cpu_calls_count_no_launches_and_other_devices_raise():
    n, h, w, c, r = 1, 4, 5, 3, 2
    img = _t(np.random.RandomState(9).rand(n, h, w, c).astype(np.float32))
    grid = torch.from_numpy(_grid(n, h, w, False, 3, seed=10))
    wb.reset_launches()
    out = wb.warp_sample_bounded_forward(img, grid, r)
    wb.warp_sample_bounded_grad_grid(img, grid, out, r)
    leaf = grid.clone().requires_grad_()
    warp.grid_sample_bounded(img, leaf, r).sum().backward()
    assert wb.warp_sample_bounded_forward.launches == 0
    assert wb.warp_sample_bounded_grad_grid.launches == 0
    meta = [t.to("meta") for t in (img, grid)]
    with pytest.raises(ValueError, match="CPU or CUDA"):
        wb.warp_sample_bounded_forward(*meta, r)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        wb.warp_sample_bounded_grad_grid(*meta, out.to("meta"), r)
    with pytest.raises(ValueError, match="padding"):
        warp.grid_sample_bounded(img, grid, r, padding_mode="reflection")


# --- (c) the warp API ---------------------------------------------------------

def _grid(n, h, w, align_corners, spread, seed):
    """A grid displaced by up to ±spread/2 pixels from the output grid."""
    rs = np.random.RandomState(seed)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    disp = (rs.rand(n, h, w, 2) - 0.5) * spread
    ix, iy = xs[None] + disp[..., 0], ys[None] + disp[..., 1]
    if align_corners:
        gx, gy = 2 * ix / (w - 1) - 1, 2 * iy / (h - 1) - 1
    else:
        gx, gy = (2 * ix + 1) / w - 1, (2 * iy + 1) / h - 1
    return np.stack([gx, gy], -1).astype(np.float32)


@pytest.mark.parametrize("bounded", [False, True])
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("align_corners", [False, True])
def test_grid_sample_matches_jax(align_corners, padding_mode, bounded):
    n, h, w, c, r = 2, 12, 16, 3, 8
    img = np.random.RandomState(0).rand(n, h, w, c).astype(np.float32)
    grid = _grid(n, h, w, align_corners, spread=6, seed=1)
    kw = dict(align_corners=align_corners, padding_mode=padding_mode)
    if bounded:
        want = jax_warp.grid_sample_bounded(jnp.asarray(img),
                                            jnp.asarray(grid), r, **kw)
        got = warp.grid_sample_bounded(_t(img), torch.from_numpy(grid), r,
                                       **kw)
    else:
        want = jax_warp.grid_sample(jnp.asarray(img), jnp.asarray(grid), **kw)
        got = warp.grid_sample(_t(img), torch.from_numpy(grid), **kw)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_bounded_sampler_clamps_beyond_the_range_as_jax(padding_mode):
    """Displacements up to ±12 px against R = 3: both packages clamp."""
    n, h, w, c, r = 1, 14, 18, 3, 3
    img = np.random.RandomState(2).rand(n, h, w, c).astype(np.float32)
    grid = _grid(n, h, w, False, spread=24, seed=3)
    want = jax_warp.grid_sample_bounded(jnp.asarray(img), jnp.asarray(grid),
                                        r, padding_mode=padding_mode)
    got = warp.grid_sample_bounded(_t(img), torch.from_numpy(grid), r,
                                   padding_mode=padding_mode)
    exact = warp.grid_sample(_t(img), torch.from_numpy(grid),
                             padding_mode=padding_mode)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)
    assert (got - exact).abs().max() > 0.05   # the clamp really bit


@pytest.mark.parametrize("warp_range", [None, 4])
@pytest.mark.parametrize("align_corners,padding_mode",
                         [(False, "zeros"), (True, "border")])
def test_backward_warp_matches_jax(align_corners, padding_mode, warp_range):
    n, h, w, c = 1, 10, 12, 3
    rs = np.random.RandomState(4)
    img = rs.rand(n, h, w, c).astype(np.float32)
    flow = ((rs.rand(n, h, w, 2) - 0.5) * 5).astype(np.float32)
    kw = dict(align_corners=align_corners, padding_mode=padding_mode,
              warp_range=warp_range)
    want = jax_warp.backward_warp(jnp.asarray(img), jnp.asarray(flow), **kw)
    got = warp.backward_warp(_t(img), torch.from_numpy(flow), **kw)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("warp_range", [None, 4])
def test_backward_warp_rrin_and_its_flow_gradient_match_jax(warp_range):
    """RRIN's warp and the gradient of a weighted sum w.r.t. the flow, the
    path of the support backward."""
    n, h, w, c = 2, 16, 20, 3
    rs = np.random.RandomState(5)
    img = rs.rand(n, h, w, c).astype(np.float32)
    flow = ((rs.rand(n, h, w, 2) - 0.5) * 5).astype(np.float32)
    g = rs.randn(n, h, w, c).astype(np.float32)

    def loss(f):
        out = jax_warp.backward_warp_rrin(jnp.asarray(img), f, warp_range)
        return jnp.sum(out * g), out

    (_, want), j_gflow = jax.value_and_grad(loss, has_aux=True)(
        jnp.asarray(flow))
    t_flow = torch.from_numpy(flow).requires_grad_()
    got = warp.backward_warp_rrin(_t(img), t_flow, warp_range)
    (got * _t(g)).sum().backward()
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(t_flow.grad.numpy(), np.asarray(j_gflow),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)


# --- (d) the bounded sampler's Function and its closed-form grid gradient --

SAMPLER_R = 3
GRID_KINDS = ["within", "past", "integer", "outside"]


def _sampler_grid(kind, align_corners, seed, ties=False, n=2):
    """(h, w, grid) for a grid kind, at 8×16 (9×17 with align_corners), where
    a whole pixel coordinate normalises exactly in float32. "within":
    displacements in (−R, R−1) off the clamp's ends; "past": up to ±(R+4),
    clamped; "integer": whole displacements in [−R+1, R−2] landing in
    [1, W−2], off the clamps' ties (JAX's clip passes half a gradient at a
    tie, torch's clamp all of it), or with ``ties`` in [−R−1, R] anywhere in
    the image; "outside": the frame zoomed out by 1.3 around its centre, so
    that the edge pixels sample off every edge of the image."""
    h, w = (9, 17) if align_corners else (8, 16)
    r = SAMPLER_R
    rs = np.random.RandomState(seed)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    pos = np.stack([xs, ys], -1)[None].astype(np.float64)
    size = np.array([w, h], np.float64)
    if kind == "within":
        coord = pos + rs.uniform(-r + 0.01, r - 1.01, (n, h, w, 2))
    elif kind == "past":
        coord = pos + rs.uniform(-r - 4, r + 4, (n, h, w, 2))
    elif kind == "integer":
        lo, hi = (-r - 1, r) if ties else (-r + 1, r - 2)
        coord = pos + rs.randint(lo, hi + 1, (n, h, w, 2))
        if not ties:
            coord = np.clip(coord, 1, size - 2)
    else:
        centre = (size - 1) / 2
        coord = ((pos - centre) * 1.3 + centre
                 + rs.uniform(-0.3, 0.3, (n, h, w, 2)))
    if align_corners:
        grid = 2 * coord / (size - 1) - 1
    else:
        grid = (2 * coord + 1) / size - 1
    return h, w, grid.astype(np.float32)


@pytest.mark.parametrize("kind", GRID_KINDS)
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("align_corners", [False, True])
def test_sampler_function_and_its_gradients_match_jax(align_corners,
                                                      padding_mode, kind):
    """GridSampleBoundedFunction's output and its grid and image gradients
    against JAX's grid_sample_bounded and its jax.vjp."""
    c, r = 3, SAMPLER_R
    h, w, grid = _sampler_grid(kind, align_corners, seed=len(kind))
    rs = np.random.RandomState(11)
    img = rs.rand(2, h, w, c).astype(np.float32)
    g = rs.randn(2, h, w, c).astype(np.float32)
    kw = dict(align_corners=align_corners, padding_mode=padding_mode)
    want, vjp = jax.vjp(
        lambda i, gr: jax_warp.grid_sample_bounded(i, gr, r, **kw),
        jnp.asarray(img), jnp.asarray(grid))
    j_img, j_grid = vjp(jnp.asarray(g))

    t_img = _t(img).requires_grad_()
    t_grid = torch.from_numpy(grid).requires_grad_()
    got = wb.GridSampleBoundedFunction.apply(t_img, t_grid, r, align_corners,
                                             padding_mode)
    (got * _t(g)).sum().backward()
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)
    for got_g, want_g, name in [(t_grid.grad.numpy(), j_grid, "grid"),
                                (_np(t_img.grad), j_img, "img")]:
        np.testing.assert_allclose(got_g, np.asarray(want_g), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)
    if kind == "past":   # the clamp really bit
        exact = warp.grid_sample(_t(img), torch.from_numpy(grid), **kw)
        assert (got - exact).abs().max() > 1e-3


@pytest.mark.parametrize("kind", GRID_KINDS)
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("align_corners", [False, True])
def test_closed_form_grid_gradient_matches_autograd(align_corners,
                                                    padding_mode, kind):
    """The closed form the backward kernel computes (and the Function runs
    on the CPU) against autograd through the plain composition, the clamps'
    ties included; the Function's forward is the plain composition, bit
    for bit."""
    c, r = 3, SAMPLER_R
    h, w, grid = _sampler_grid(kind, align_corners, seed=7 + len(kind),
                               ties=True)
    rs = np.random.RandomState(12)
    img = _t(rs.rand(2, h, w, c).astype(np.float32))
    g = _t(rs.randn(2, h, w, c).astype(np.float32))
    leaf = torch.from_numpy(grid).requires_grad_()
    want = wb.grid_sample_bounded_ref(img, leaf, r, align_corners,
                                      padding_mode)
    (want * g).sum().backward()
    got = wb.grid_sample_bounded_grad_grid_ref(img, leaf.detach(), g, r,
                                               align_corners, padding_mode)
    torch.testing.assert_close(got, leaf.grad, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    assert got.abs().max() > 0
    assert torch.equal(wb.GridSampleBoundedFunction.apply(
        img, leaf.detach(), r, align_corners, padding_mode), want.detach())


# --- (e) reflect padding ------------------------------------------------------

@pytest.mark.parametrize("shape,pad", [
    ((1, 5, 6, 2), 2),
    ((2, 4, 7, 3), (1, 3, 2, 0)),
    ((1, 3, 5, 1), (9, 4, 7, 11)),        # wider than the dimension
    ((1, 1, 4, 2), (2, 1, 3, 2)),         # a dimension of one
])
def test_reflect_pad_matches_jnp_pad(shape, pad):
    x = np.random.RandomState(0).rand(*shape).astype(np.float32)
    want = jax_layers.reflect_pad(jnp.asarray(x), pad)
    got = layers.reflect_pad(_t(x), pad)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("hw", [(40, 40), (64, 64), (37, 130), (128, 256)])
def test_pad_to_multiple_and_unpad_match_jax(hw):
    """A 40×40 crop pads to 128 with 44 on each side: wider than the crop."""
    x = np.random.RandomState(1).rand(1, *hw, 3).astype(np.float32)
    want, j_pads = jax_layers.pad_to_multiple(jnp.asarray(x), 128)
    got, pads = layers.pad_to_multiple(_t(x), 128)
    assert tuple(pads) == tuple(j_pads)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    np.testing.assert_array_equal(
        _np(layers.unpad(got, pads)),
        np.asarray(jax_layers.unpad(want, j_pads)))
    np.testing.assert_array_equal(_np(layers.unpad(got, pads)), x)


def test_leaky_relu_matches_jax():
    x = np.random.RandomState(2).randn(2, 3, 4, 5).astype(np.float32)
    for slope in (0.1, 0.2):
        np.testing.assert_allclose(
            layers.leaky_relu(torch.from_numpy(x), slope).numpy(),
            np.asarray(jax_layers.leaky_relu(jnp.asarray(x), slope)),
            rtol=1e-6)
