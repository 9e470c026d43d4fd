"""The bounded sampler's second derivative (ops/warp_bounded.py: K3-grad²
and its plain version, GridSampleBoundedGradGridFunction) held against the
JAX package on the CPU.

The JAX package's bounded warp differentiates a second time through its
plain XLA backward (``meta_interpolation_tpu/ops/warp.py``
``grid_sample_bounded``): for the cotangent v of the grid gradient, the
cotangent of the output gradient g is ``jax.jvp`` of the sampler in the
direction v, and the grid's is ``jax.jvp`` of ``jax.grad`` (the Hessian is
symmetric). On CPU tensors the port's wrapper runs its plain version
(autograd through the closed-form grid gradient); the CUDA kernel is held
against that version on the card by chip_smoke.py. A torch transcription
of the kernel's per-pixel formula (csrc/warp.cu) is held here to the plain
version, so the algorithm the kernel runs is tested where no card is. On a
band of output rows from ``row0`` (row-sharded second-order training) the
plain version, the formula and the second derivative of a band's sample
give the whole frame's rows, bit for bit.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_warp_train import one_thread  # noqa: F401
from meta_interpolation_tpu.ops import warp as jax_warp
from meta_interpolation_tpu_torch.ops import _build
from meta_interpolation_tpu_torch.ops import warp_bounded as wb

pytestmark = pytest.mark.usefixtures("one_thread")

R = 4
# float32 on both sides, other summation orders
TOL_REL, TOL_ABS = 1e-5, 1e-6
KINDS = ["within", "past", "outside"]


def _t(x):
    """NHWC numpy → NCHW torch."""
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _grid(kind, align_corners, seed, n=2, dtype=np.float32):
    """(h, w, grid): "within" displaces every sample by less than R − 1
    per axis, off the clamp's ends; "past" by up to R + 4, where the clamp
    acts; "outside" zooms the frame out by 1.3 around its centre, so that
    the edge pixels sample off every edge."""
    h, w = (9, 17) if align_corners else (8, 16)
    rs = np.random.RandomState(seed)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    pos = np.stack([xs, ys], -1)[None].astype(np.float64)
    size = np.array([w, h], np.float64)
    if kind == "within":
        coord = pos + rs.uniform(-R + 0.01, R - 1.01, (n, h, w, 2))
    elif kind == "past":
        coord = pos + rs.uniform(-R - 4, R + 4, (n, h, w, 2))
    else:
        centre = (size - 1) / 2
        coord = ((pos - centre) * 1.3 + centre
                 + rs.uniform(-0.3, 0.3, (n, h, w, 2)))
    if align_corners:
        grid = 2 * coord / (size - 1) - 1
    else:
        grid = (2 * coord + 1) / size - 1
    return h, w, grid.astype(dtype)


def _inputs(kind, align_corners, seed, c=3):
    h, w, grid = _grid(kind, align_corners, seed)
    rs = np.random.RandomState(seed + 100)
    img = rs.rand(2, h, w, c).astype(np.float32)
    g = rs.randn(2, h, w, c).astype(np.float32)
    v = rs.randn(2, h, w, 2).astype(np.float32)
    return img, grid, g, v


def _close(got, want, what):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    lim = TOL_REL * np.abs(want).max() + TOL_ABS
    assert err <= lim, (what, err, lim)
    assert np.abs(want).max() > 0, what


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("align_corners", [False, True])
def test_double_backward_matches_jax(align_corners, padding_mode, kind):
    """gg (the output gradient's cotangent) and the grid's second-order
    cotangent of the port's plain double backward, and of the autograd
    Function's (sampler → grid gradient with create_graph → its
    gradient), against JAX's jvp of the sampler and jvp of its grad."""
    img, grid, g, v = _inputs(kind, align_corners, seed=3 + len(kind))
    kw = dict(align_corners=align_corners, padding_mode=padding_mode)
    sampler = lambda gr: jax_warp.grid_sample_bounded(jnp.asarray(img), gr,
                                                      R, **kw)
    grad_grid = jax.grad(lambda gr: jnp.sum(sampler(gr) * g))
    _, want_gg = jax.jvp(sampler, (jnp.asarray(grid),), (jnp.asarray(v),))
    _, want_grid = jax.jvp(grad_grid, (jnp.asarray(grid),),
                           (jnp.asarray(v),))
    want_gg = np.asarray(want_gg).transpose(0, 3, 1, 2)

    t_img, t_grid, t_g, t_v = (_t(img), torch.from_numpy(grid), _t(g),
                               torch.from_numpy(v))
    gg, ggrid = wb.grid_sample_bounded_grad_grid_backward_ref(
        t_img, t_grid, t_g, t_v, R, align_corners, padding_mode)
    _close(gg.detach().numpy(), want_gg, "plain gg")
    _close(ggrid.detach().numpy(), want_grid, "plain grid")

    leaf, g_leaf = t_grid.clone().requires_grad_(), t_g.clone().requires_grad_()
    first, = torch.autograd.grad(
        wb.GridSampleBoundedFunction.apply(t_img, leaf, R, align_corners,
                                           padding_mode),
        leaf, g_leaf, create_graph=True)
    got_gg, got_grid = torch.autograd.grad(first, (g_leaf, leaf), t_v)
    _close(got_gg.detach().numpy(), want_gg, "Function gg")
    _close(got_grid.detach().numpy(), want_grid, "Function grid")


def _kernel_formula(img, grid, g, v, r, align_corners, padding_mode,
                    row0=0):
    """csrc/warp.cu's warp_sample_grad_grid_backward_kernel, per pixel, in
    torch: the channel sums S_x, S_y, S_b, S_xy and the Hessian terms of
    its header comment; the grid's rows are image rows row0 onwards."""
    n, c, h, w = img.shape
    border = padding_mode == "border"
    ix, iy = wb._unnormalize(grid, h, w, align_corners)
    xs = torch.arange(w, dtype=ix.dtype)[None, None, :]
    ys = torch.arange(row0, row0 + grid.shape[1], dtype=ix.dtype)[
        None, :, None]
    dx0, fx, mx, dmx, cx, vx = wb._axis(ix, xs, w, r, border)
    dy0, fy, my, dmy, cy, vy = wb._axis(iy, ys, h, r, border)
    (v00, v01, v10, v11), _, _ = wb._taps(img, dy0, dx0, r, row0)
    e = lambda t: t[:, None]
    fx4, fy4 = e(fx), e(fy)
    top, bot = (1 - fx4) * v00 + fx4 * v01, (1 - fx4) * v10 + fx4 * v11
    dbx = (1 - fy4) * (v01 - v00) + fy4 * (v11 - v10)
    dby, bil = bot - top, (1 - fy4) * top + fy4 * bot
    s = lambda t: (g * t).sum(1)
    sx_, sy_, sb, sxy = s(dbx), s(dby), s(bil), s((v11 - v10) - (v01 - v00))
    sx = 0.5 * ((w - 1) if align_corners else w)
    sy = 0.5 * ((h - 1) if align_corners else h)
    ux, uy = v[..., 0] * sx, v[..., 1] * sy
    if border:
        hxy = cx * cy * sxy
        gg = e(ux * cx) * dbx + e(uy * cy) * dby
        return gg, torch.stack([sx * uy * hxy, sy * ux * hxy], -1)
    live = vx & vy
    gg = (e(ux * my * mx * cx) * dbx + e(uy * mx * my * cy) * dby
          + e(ux * my * dmx + uy * mx * dmy) * bil)
    hxx, hyy = 2 * my * dmx * cx * sx_, 2 * mx * dmy * cy * sy_
    hxy = (dmy * mx * cx * sx_ + mx * my * cx * cy * sxy + dmx * dmy * sb
           + my * dmx * cy * sy_)
    ggrid = torch.stack([sx * (ux * hxx + uy * hxy),
                         sy * (ux * hxy + uy * hyy)], -1)
    return (torch.where(e(live), gg, 0.0),
            torch.where(live[..., None], ggrid, 0.0))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("align_corners", [False, True])
def test_kernel_formula_is_the_plain_double_backward(align_corners,
                                                     padding_mode, kind):
    """The closed form the kernel computes against autograd through the
    closed-form grid gradient (its plain version), in float64."""
    img, grid, g, v = (torch.from_numpy(x).double() if x.ndim == 4 and
                       x.shape[-1] == 2 else _t(x).double()
                       for x in _inputs(kind, align_corners, seed=11))
    got = _kernel_formula(img, grid, g, v, R, align_corners, padding_mode)
    want = wb.grid_sample_bounded_grad_grid_backward_ref(
        img, grid, g, v, R, align_corners, padding_mode)
    for a, b, what in zip(got, want, ("gg", "grid")):
        torch.testing.assert_close(a, b.detach(), rtol=1e-12, atol=1e-10,
                                   msg=what)


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("align_corners", [False, True])
def test_gradcheck_in_float64(align_corners, padding_mode):
    """gradcheck of GridSampleBoundedGradGridFunction (its backward is
    K3-grad²'s plain version) and gradgradcheck of the sampler's Function
    in the grid, against finite differences, in float64."""
    h, w, grid = _grid("past", align_corners, seed=5, n=1, dtype=np.float64)
    rs = np.random.RandomState(6)
    img = torch.from_numpy(rs.rand(1, 2, h, w))
    grid = torch.from_numpy(grid).requires_grad_()
    g = torch.from_numpy(rs.randn(1, 2, h, w)).requires_grad_()
    opts = (R, align_corners, padding_mode)
    assert torch.autograd.gradcheck(
        lambda gr, gq: wb.GridSampleBoundedGradGridFunction.apply(
            img, gr, gq, *opts), (grid, g))
    assert torch.autograd.gradgradcheck(
        lambda gr: wb.GridSampleBoundedFunction.apply(img, gr, *opts),
        (grid,))


@functools.lru_cache(maxsize=None)
def _whole_frame(align_corners, padding_mode, r):
    """A frame's inputs ("past": displacements past R = 4) and JAX's
    second derivative of ``grid_sample_bounded`` at R: ``jax.vjp`` of its
    grid gradient (in the grid and g) for the cotangent v, (gg, grid) as
    the port lays them out."""
    img, grid, g, v = _inputs("past", align_corners, seed=21)
    kw = dict(align_corners=align_corners, padding_mode=padding_mode)

    def grad_grid(gr, gq):
        return jax.grad(lambda gr: jnp.sum(jax_warp.grid_sample_bounded(
            jnp.asarray(img), gr, r, **kw) * gq))(gr)
    _, vjp = jax.vjp(grad_grid, jnp.asarray(grid), jnp.asarray(g))
    want_grid, want_gg = vjp(jnp.asarray(v))
    return ((_t(img), torch.from_numpy(grid), _t(g), torch.from_numpy(v)),
            np.asarray(want_gg).transpose(0, 3, 1, 2), np.asarray(want_grid))


BANDS = {"first": (0, 3), "middle": (3, 3), "last": (-3, 3),
         "one_row": (4, 1)}


@pytest.mark.parametrize("band", list(BANDS))
@pytest.mark.parametrize("r", [R, 8])
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("align_corners", [False, True])
def test_band_double_backward_is_the_whole_frames_rows(align_corners,
                                                       padding_mode, r,
                                                       band):
    """K3-grad²'s plain version on a band of rows from ``row0``, through
    its wrapper on CPU tensors: bit for bit the whole frame's same rows,
    which are JAX's second derivative of ``grid_sample_bounded`` within
    1e-5·max + 1e-6; the kernel's per-pixel formula on the band (in
    float64) the plain version's; and the second derivative of a band's
    sample, through the autograd Functions, the same rows."""
    (img, grid, g, v), want_gg, want_grid = _whole_frame(
        align_corners, padding_mode, r)
    opts = (r, align_corners, padding_mode)
    whole = wb.warp_sample_bounded_grad_grid_backward(img, grid, g, v, *opts)
    _close(whole[0].detach().numpy(), want_gg, "whole gg")
    _close(whole[1].detach().numpy(), want_grid, "whole grid")
    row0, rows = BANDS[band]
    row0 %= img.shape[2]
    sl = slice(row0, row0 + rows)
    args = (img, grid[:, sl], g[:, :, sl], v[:, sl])
    got = wb.warp_sample_bounded_grad_grid_backward(*args, *opts, row0=row0)
    assert got[0].shape == (2, 3, rows, img.shape[3])
    assert torch.equal(got[0], whole[0][:, :, sl])
    assert torch.equal(got[1], whole[1][:, sl])
    formula = _kernel_formula(*(t.double() for t in args), *opts, row0=row0)
    plain = wb.grid_sample_bounded_grad_grid_backward_ref(
        *(t.double() for t in args), *opts, row0)
    for a, b, what in zip(formula, plain, ("gg", "grid")):
        torch.testing.assert_close(a, b.detach(), rtol=1e-12, atol=1e-10,
                                   msg=what)
    leaf, g_leaf = (args[1].clone().requires_grad_(),
                    args[2].clone().requires_grad_())
    first, = torch.autograd.grad(
        wb.GridSampleBoundedFunction.apply(img, leaf, *opts, row0), leaf,
        g_leaf, create_graph=True)
    got_gg, got_grid = torch.autograd.grad(first, (g_leaf, leaf), args[3])
    assert torch.equal(got_gg, whole[0][:, :, sl])
    assert torch.equal(got_grid, whole[1][:, sl])


def test_cpu_wrapper_counts_no_launches_and_other_devices_raise():
    img, grid, g, v = (torch.from_numpy(x) if x.shape[-1] == 2 else _t(x)
                       for x in _inputs("within", False, seed=7))
    wb.reset_launches()
    gg, ggrid = wb.warp_sample_bounded_grad_grid_backward(img, grid, g, v, R)
    want = wb.grid_sample_bounded_grad_grid_backward_ref(img, grid, g, v, R)
    assert torch.equal(gg, want[0]) and torch.equal(ggrid, want[1])
    assert wb.warp_sample_bounded_grad_grid_backward.launches == 0
    with pytest.raises(ValueError, match="CPU or CUDA"):
        wb.warp_sample_bounded_grad_grid_backward(
            *(t.to("meta") for t in (img, grid, g, v)), R)


def test_image_gradient_refuses_a_second_derivative():
    """The image gradient stays plain and once differentiable: a second
    order that needs it raises instead of returning a wrong zero."""
    img, grid, _, _ = (torch.from_numpy(x) if x.shape[-1] == 2 else _t(x)
                       for x in _inputs("within", False, seed=8))
    img.requires_grad_()
    out = wb.GridSampleBoundedFunction.apply(img, grid, R, False, "zeros")
    with pytest.raises(NotImplementedError, match="image gradient"):
        torch.autograd.grad(out.sum(), img, create_graph=True)
    gimg, = torch.autograd.grad(out.sum(), img)
    assert float(gimg.abs().sum()) > 0


def test_dense_materializes_an_efficient_zero_tensor():
    """A second-order backward may hand a kernel wrapper an efficient zero
    tensor (no storage: a null data pointer, an illegal address to a
    kernel); the wrappers read it as a dense zero tensor."""
    zero = torch._efficientzerotensor((2, 3, 4))
    assert zero._is_zerotensor()
    dense = _build.dense(zero)
    assert not dense._is_zerotensor() and dense.data_ptr() != 0
    assert torch.equal(dense, torch.zeros(2, 3, 4))
    t = torch.randn(3, 4).t()
    assert _build.dense(t).is_contiguous() and torch.equal(_build.dense(t), t)
