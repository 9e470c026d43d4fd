"""The port's kernels in bfloat16 (--dtype bfloat16) held on the CPU
against the JAX package's TPU kernels run in interpret mode.

On CPU tensors the port's wrappers run their plain versions with the
kernels' bf16 semantics: widen every value to float32, sum in float32,
round each output once (K1, K2); round the fractions to bf16, sum the taps
in float32 and round once, and with zero padding round the mass and its
product (K3); K3-grad in float32 on the rounded fractions. The JAX package's
TPU kernels do the same (``_pallas_forward`` and ``_pallas_grad_kernels``
upcast, ``warp_bounded_pallas`` upcasts, the glue rounds the fractions and
the mass), and are run here with ``interpret=True``; its CPU fallbacks
(``sepconv_ref``, ``_warp_bounded_xla``) sum in bf16 instead and are not
what the port holds to. The CUDA kernels themselves are held to these
plain versions on the card by chip_smoke.py.

Tolerance: one bf16 ulp of max|reference| plus 1e-5. Both sides round a
float32 sum once; only the summation order differs, which can move a
value across a rounding boundary by one ulp.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meta_interpolation_tpu.ops import flow_projection_pallas as jax_fpp
from meta_interpolation_tpu.ops import sepconv as jax_sc
from meta_interpolation_tpu.ops import warp as jax_warp
from meta_interpolation_tpu.ops import warp_pallas
from meta_interpolation_tpu_torch.ops import flow_projection_bounded as fpb
from meta_interpolation_tpu_torch.ops import sepconv as sc
from meta_interpolation_tpu_torch.ops import warp
from meta_interpolation_tpu_torch.ops import warp_bounded as wb

ABS_FLOOR = 1e-5

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bf16(x):
    """numpy float32 → the same values rounded to bf16, as float32 numpy
    (what both frameworks read)."""
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _t(x, dtype=torch.bfloat16):
    """NHWC / (N, H, W, F) numpy → NCHW / (N, F, H, W) torch."""
    return torch.from_numpy(np.ascontiguousarray(
        x.transpose(0, 3, 1, 2))).to(dtype)


def _np(t):
    """NCHW torch → NHWC float32 numpy."""
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _within_one_ulp(got, want, what=""):
    """max|got − want| ≤ one bf16 ulp of max|want| + ABS_FLOOR."""
    want = np.asarray(want, np.float32)
    top = float(np.abs(want).max())
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 0.0
    err = float(np.abs(np.asarray(got, np.float32) - want).max())
    assert err <= ulp + ABS_FLOOR, f"{what}: {err:.3e} > {ulp + ABS_FLOOR:.3e}"


def _sep_data(n, h, w, f, seed):
    rs = np.random.RandomState(seed)
    inp = _bf16(rs.rand(n, h + f - 1, w + f - 1, 3).astype(np.float32))
    kv = _bf16(rs.randn(n, h, w, f).astype(np.float32))
    kh = _bf16(rs.randn(n, h, w, f).astype(np.float32))
    g = _bf16(rs.randn(n, h, w, 3).astype(np.float32))
    return inp, kv, kh, g


@pytest.mark.parametrize("n,h,w,f", [(1, 8, 16, 51), (2, 5, 7, 50),
                                     (2, 6, 7, 5)])
def test_plain_bf16_k1_k2_match_the_interpret_mode_kernels(n, h, w, f):
    inp, kv, kh, g = _sep_data(n, h, w, f, seed=f + h)
    j = [jnp.asarray(x, jnp.bfloat16) for x in (inp, kv, kh, g)]
    want = jax_sc._pallas_forward(j[0], j[1], j[2], f, interpret=True)
    want_kv, want_kh = jax_sc._pallas_grad_kernels(j[0], j[3], j[1], j[2],
                                                   f, interpret=True)
    assert want.dtype == want_kv.dtype == jnp.bfloat16
    t = [_t(x) for x in (inp, kv, kh, g)]
    got = sc.sepconv_forward(t[0], t[1], t[2])
    got_kv, got_kh = sc.sepconv_grad_kernels(t[0], t[3], t[1], t[2])
    assert got.dtype == got_kv.dtype == got_kh.dtype == torch.bfloat16
    _within_one_ulp(_np(got), want.astype(jnp.float32), "K1")
    _within_one_ulp(_np(got_kv), want_kv.astype(jnp.float32), "K2 gkv")
    _within_one_ulp(_np(got_kh), want_kh.astype(jnp.float32), "K2 gkh")


def test_plain_bf16_k1_is_the_float32_sum_rounded_once():
    """The port's bf16 K1 is its float32 K1 on the widened inputs, rounded:
    bit for bit, as the card's bf16 instantiation is held to its float32
    one."""
    inp, kv, kh, _ = _sep_data(1, 6, 9, 51, seed=3)
    t = [_t(x) for x in (inp, kv, kh)]
    wide = sc.sepconv_forward(*(x.float() for x in t)).to(torch.bfloat16)
    assert torch.equal(sc.sepconv_forward(*t), wide)


def test_kernel_shapes_refuse_mixed_and_other_types():
    inp, kv, kh, _ = _sep_data(1, 4, 5, 5, seed=4)
    t = [_t(x) for x in (inp, kv, kh)]
    assert sc._kernel_shapes(*t)[4] == 5
    with pytest.raises(ValueError, match="all of one type"):
        sc._kernel_shapes(t[0], t[1].float(), t[2])
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        sc._kernel_shapes(*(x.half() for x in t))


def test_sepconv_double_backward_runs_in_bf16():
    """SepConvGradKernelsFunction keeps its double backward in bf16: the
    second-order path's gradients come back bf16 and match the float32
    double backward within bf16's own rounding."""
    inp, kv, kh, g = _sep_data(1, 4, 6, 5, seed=6)
    outs = {}
    for dtype in (torch.bfloat16, torch.float32):
        leaves = [_t(x, dtype).requires_grad_(i > 0)
                  for i, x in enumerate((inp, kv, kh))]
        out = sc.sepconv(*leaves)
        gkv, gkh = torch.autograd.grad((out * _t(g, dtype)).sum(),
                                       leaves[1:], create_graph=True)
        second = torch.autograd.grad((gkv * gkv).sum() + gkh.sum(),
                                     leaves[1:])
        outs[dtype] = second
    for got, want in zip(outs[torch.bfloat16], outs[torch.float32]):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want.numpy(),
                                   rtol=0, atol=2e-2 * float(
                                       want.abs().max()))


def _grid(n, h, w, spread, align_corners, seed):
    rs = np.random.RandomState(seed)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    coord = (np.stack([xs, ys], -1)[None]
             + rs.uniform(-spread, spread, (n, h, w, 2)))
    size = np.array([w, h], np.float64)
    if align_corners:
        return (2 * coord / (size - 1) - 1).astype(np.float32)
    return ((2 * coord + 1) / size - 1).astype(np.float32)


def _interpret_sweep(img, dy0, dx0, fy, fx, r):
    """The JAX glue's sweep, routed to the TPU kernel in interpret mode
    (it needs W % 128 == 0 and H % 8 == 0)."""
    return warp_pallas.warp_bounded_pallas(img, dy0, dx0, fy, fx, r,
                                           interpret=True)


def _f32_sweep(img, dy0, dx0, fy, fx, r, _xla=jax_warp._warp_bounded_xla):
    """The interpret-mode kernel's function, differentiable: the XLA sweep
    on the widened image and fractions, rounded once."""
    f32 = jnp.float32
    return _xla(img.astype(f32), dy0, dx0, fy.astype(f32), fx.astype(f32),
                r).astype(img.dtype)


@pytest.mark.parametrize("padding_mode,align_corners",
                         [("zeros", False), ("border", True),
                          ("zeros", True)])
@pytest.mark.parametrize("spread", [3.0, 7.0])
def test_plain_bf16_k3_matches_the_interpret_mode_kernel(
        monkeypatch, padding_mode, align_corners, spread):
    """K3 in bf16, the whole sampler (fractions rounded to bf16, the f32
    tap sum rounded, with zeros the mass and its product rounded), against
    JAX's grid_sample_bounded with its sweep on the TPU kernel; spread 7
    reaches past R = 4, where both clamp."""
    n, h, w, c, r = 1, 8, 128, 3, 4
    rs = np.random.RandomState(int(spread))
    img = _bf16(rs.rand(n, h, w, c).astype(np.float32))
    grid = _grid(n, h, w, spread, align_corners, seed=int(spread) + 1)
    monkeypatch.setattr(jax_warp, "_warp_bounded_xla", _interpret_sweep)
    kw = dict(align_corners=align_corners, padding_mode=padding_mode)
    want = jax_warp.grid_sample_bounded(jnp.asarray(img, jnp.bfloat16),
                                        jnp.asarray(grid), r, **kw)
    assert want.dtype == jnp.bfloat16
    got = warp.grid_sample_bounded(_t(img, torch.bfloat16),
                                   torch.from_numpy(grid), r, **kw)
    assert got.dtype == torch.bfloat16
    _within_one_ulp(_np(got), want.astype(jnp.float32), "K3")
    # a bf16 grid is widened: the same coordinates, the same result
    grid_b = torch.from_numpy(grid).to(torch.bfloat16)
    assert torch.equal(
        warp.grid_sample_bounded(_t(img), grid_b, r, **kw),
        warp.grid_sample_bounded(_t(img), grid_b.float(), r, **kw))


@pytest.mark.parametrize("padding_mode,align_corners",
                         [("zeros", False), ("border", True)])
def test_plain_bf16_k3_grad_matches_jax_vjp_through_the_kernel_function(
        monkeypatch, padding_mode, align_corners):
    """K3-grad in bf16 (float32 sums on the rounded fractions; the grid's
    type out) against jax.vjp of grid_sample_bounded whose sweep is the
    TPU kernel's function (``_f32_sweep``: the interpret-mode kernel's
    forward above, in differentiable form)."""
    n, h, w, c, r = 2, 8, 16, 3, 4
    rs = np.random.RandomState(9)
    img = _bf16(rs.rand(n, h, w, c).astype(np.float32))
    g = _bf16(rs.randn(n, h, w, c).astype(np.float32))
    grid = _grid(n, h, w, 3.0, align_corners, seed=10)
    monkeypatch.setattr(jax_warp, "_warp_bounded_xla", _f32_sweep)
    kw = dict(align_corners=align_corners, padding_mode=padding_mode)
    _, vjp = jax.vjp(lambda gr: jax_warp.grid_sample_bounded(
        jnp.asarray(img, jnp.bfloat16), gr, r, **kw), jnp.asarray(grid))
    want, = vjp(jnp.asarray(g, jnp.bfloat16))
    got = wb.warp_sample_bounded_grad_grid(
        _t(img), torch.from_numpy(grid), _t(g), r, align_corners,
        padding_mode)
    assert got.dtype == torch.float32
    _within_one_ulp(got.numpy(), want, "K3-grad")
    got_b = wb.warp_sample_bounded_grad_grid(
        _t(img), torch.from_numpy(grid).to(torch.bfloat16), _t(g), r,
        align_corners, padding_mode)
    assert got_b.dtype == torch.bfloat16


def test_k3_grad2_and_k4_widen_bf16_operands_and_round_back():
    """K3-grad² and K4 are float32 kernels: on bf16 operands their
    wrappers widen, run the float32 function and round each result back,
    as the JAX package's flow_projection_bounded wrapper does."""
    n, h, w, c, r = 1, 6, 9, 3, 4
    rs = np.random.RandomState(12)
    img = _t(rs.rand(n, h, w, c).astype(np.float32))
    g = _t(rs.randn(n, h, w, c).astype(np.float32))
    grid = torch.from_numpy(_grid(n, h, w, 2.0, False, seed=13))
    v = torch.from_numpy(rs.randn(n, h, w, 2).astype(np.float32))
    gg, ggrid = wb.warp_sample_bounded_grad_grid_backward(img, grid, g, v, r)
    wgg, wggrid = wb.warp_sample_bounded_grad_grid_backward(
        img.float(), grid, g.float(), v, r)
    assert gg.dtype == torch.bfloat16 and ggrid.dtype == torch.float32
    assert torch.equal(gg, wgg.to(torch.bfloat16))
    assert torch.equal(ggrid, wggrid)

    flow = (rs.rand(2, 16, 16, 2).astype(np.float32) - 0.5) * 6
    depth = rs.rand(2, 16, 16, 1).astype(np.float32) + 0.5
    proj, cnt = fpb.flow_projection_bounded(
        torch.from_numpy(flow).bfloat16(), torch.from_numpy(depth).bfloat16(),
        3)
    wproj, wcnt = fpb.flow_projection_bounded(
        torch.from_numpy(_bf16(flow)), torch.from_numpy(_bf16(depth)), 3)
    assert proj.dtype == cnt.dtype == torch.bfloat16
    assert torch.equal(proj, wproj.bfloat16())
    assert torch.equal(cnt, wcnt.bfloat16())
    jproj, jcnt = jax_fpp.flow_projection_bounded(
        jnp.asarray(flow, jnp.bfloat16), jnp.asarray(depth, jnp.bfloat16),
        3, interpret=True)
    assert jproj.dtype == jnp.bfloat16
    _within_one_ulp(proj.float().numpy(), jproj.astype(jnp.float32), "K4")
    _within_one_ulp(cnt.float().numpy(), jcnt.astype(jnp.float32), "K4 cnt")


def test_exact_sampler_keeps_float32_coordinates_in_bf16():
    """The exact sampler on a bf16 image samples at the float32 grid (JAX
    ops/warp.py:169-171), widened and rounded once: a bf16 grid would move
    samples by up to W/256 pixels. Its double backward runs too."""
    n, h, w, c = 1, 8, 64, 3
    rs = np.random.RandomState(14)
    img = torch.from_numpy(rs.rand(n, c, h, w).astype(np.float32))
    grid = torch.from_numpy(_grid(n, h, w, 2.0, False, seed=15))
    got = warp.grid_sample(img.bfloat16(), grid)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, warp.grid_sample(img.bfloat16().float(),
                                             grid).bfloat16())
    leaf = grid.clone().requires_grad_()
    first, = torch.autograd.grad(warp.grid_sample(img.bfloat16(), leaf).sum(),
                                 leaf, create_graph=True)
    second, = torch.autograd.grad(first.square().sum(), leaf)
    assert second.dtype == torch.float32 and torch.isfinite(second).all()
