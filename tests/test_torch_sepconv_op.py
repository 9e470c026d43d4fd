"""The port's sepconv op (meta_interpolation_tpu_torch/ops/sepconv.py) held
against the JAX op on the CPU.

On CPU tensors the port's wrappers run their plain PyTorch versions; the
CUDA kernels they stand for are held against the same plain versions on
the card by chip_smoke.py. Inputs come from a numpy seed; JAX is NHWC with
(N, H, W, F) kernel maps, the port NCHW with (N, F, H, W).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meta_interpolation_tpu.ops import sepconv as jax_sc
from meta_interpolation_tpu_torch.ops import sepconv as sc

# only the summation order differs between the two frameworks
FWD_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5


def _data(n, h, w, f, c=3, seed=0):
    rs = np.random.RandomState(seed)
    inp = rs.rand(n, h + f - 1, w + f - 1, c).astype(np.float32)
    kv = rs.rand(n, h, w, f).astype(np.float32)
    kh = rs.rand(n, h, w, f).astype(np.float32)
    g = rs.rand(n, h, w, c).astype(np.float32)
    return inp, kv, kh, g


def _t(x):
    """NHWC / (N,H,W,F) numpy → NCHW / (N,F,H,W) torch."""
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _np(t):
    """NCHW torch → NHWC numpy."""
    return t.detach().numpy().transpose(0, 2, 3, 1)


# the shapes chip_smoke.py holds the kernels to, shrunk: N = 2, F small,
# even and 51, H and W off every tile and strip
@pytest.mark.parametrize("n,h,w,f", [(2, 6, 7, 5), (1, 5, 9, 51),
                                     (2, 5, 7, 50), (2, 3, 5, 51)])
def test_plain_forward_matches_jax_ref(n, h, w, f):
    inp, kv, kh, _ = _data(n, h, w, f, seed=f)
    expected = jax_sc.sepconv_ref(jnp.asarray(inp), jnp.asarray(kv),
                                  jnp.asarray(kh))
    got = sc.sepconv_forward(_t(inp), _t(kv), _t(kh))
    np.testing.assert_allclose(_np(got), np.asarray(expected), rtol=FWD_RTOL)


@pytest.mark.parametrize("n,h,w,f", [(1, 4, 5, 3), (1, 3, 4, 51),
                                     (2, 3, 5, 5), (1, 3, 4, 50),
                                     (2, 2, 3, 51)])
def test_plain_gradients_match_jax_grad(n, h, w, f):
    """gkv, gkh (K2's plain version) and gin against jax.grad of the JAX
    op's custom VJP on its plain path."""
    inp, kv, kh, g = _data(n, h, w, f, seed=10 + f)

    def loss(i, v, hh):
        return jnp.sum(jax_sc.sepconv(i, v, hh, False) * jnp.asarray(g))

    j_in, j_kv, j_kh = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(inp), jnp.asarray(kv), jnp.asarray(kh))
    gkv, gkh = sc.sepconv_grad_kernels(_t(inp), _t(g), _t(kv), _t(kh))
    gin = sc.grad_input_ref(_t(g), _t(kv), _t(kh), inp.shape[1],
                            inp.shape[2])
    for got, want, name in [(gkv, j_kv, "gkv"), (gkh, j_kh, "gkh"),
                            (gin, j_in, "gin")]:
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)


def test_plain_versions_match_pallas_interpret():
    """Both TPU kernels in Pallas interpret mode, as the JAX package's own
    tests run them (tests/test_sepconv_op.py)."""
    f = 5
    inp, kv, kh, g = _data(2, 8, 8, f, seed=2)
    ji, jv, jh = jnp.asarray(inp), jnp.asarray(kv), jnp.asarray(kh)
    out = jax_sc._pallas_forward(ji, jv, jh, f=f, interpret=True)
    p_kv, p_kh = jax_sc._pallas_grad_kernels(ji, jnp.asarray(g), jv, jh, f=f,
                                             interpret=True)
    got = sc.sepconv_forward(_t(inp), _t(kv), _t(kh))
    gkv, gkh = sc.sepconv_grad_kernels(_t(inp), _t(g), _t(kv), _t(kh))
    np.testing.assert_allclose(_np(got), np.asarray(out), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    np.testing.assert_allclose(_np(gkv), np.asarray(p_kv), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    np.testing.assert_allclose(_np(gkh), np.asarray(p_kh), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)


@pytest.mark.parametrize("input_grad", [False, True])
def test_function_backward_matches_autograd_of_plain_forward(input_grad):
    inp, kv, kh, g = _data(1, 5, 6, 7, seed=3)
    tg = _t(g)

    def grads(fn):
        i = _t(inp).requires_grad_(input_grad)
        v, hh = _t(kv).requires_grad_(), _t(kh).requires_grad_()
        (fn(i, v, hh) * tg).sum().backward()
        return i.grad, v.grad, hh.grad

    got = grads(sc.sepconv)
    want = grads(sc.sepconv_ref)
    if not input_grad:
        assert got[0] is None
    for a, b in zip(got, want):
        if b is not None:
            torch.testing.assert_close(a, b, rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_cpu_calls_count_no_launches_and_other_devices_raise():
    inp, kv, kh, g = _data(1, 3, 3, 3, seed=4)
    sc.reset_launches()
    sc.sepconv(_t(inp), _t(kv), _t(kh))
    sc.sepconv_grad_kernels(_t(inp), _t(g), _t(kv), _t(kh))
    assert sc.sepconv_forward.launches == 0
    assert sc.sepconv_grad_kernels.launches == 0
    meta = [_t(x).to("meta") for x in (inp, kv, kh)]
    with pytest.raises(ValueError, match="CPU or CUDA"):
        sc.sepconv_forward(*meta)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        sc.sepconv_grad_kernels(meta[0], _t(g).to("meta"), meta[1], meta[2])


def _meta(n, c, h, w, f, dtype=torch.float32):
    """Tensors of the kernels' shapes on the meta device: no storage."""
    inp = torch.empty(n, c, h + f - 1, w + f - 1, dtype=dtype, device="meta")
    kv = torch.empty(n, f, h, w, dtype=dtype, device="meta")
    return inp, kv


@pytest.mark.parametrize("n,h,w,f", [(1, 37, 53, 51), (2, 21, 70, 51),
                                     (2, 21, 70, 5), (1, 37, 53, 50),
                                     (1, 384, 512, 51)])
def test_kernel_shapes_take_the_card_shapes(n, h, w, f):
    inp, kv = _meta(n, 3, h, w, f)
    assert sc._kernel_shapes(inp, kv, kv) == (n, 3, h, w, f)


@pytest.mark.parametrize("c,f,dtype,match", [
    (4, 5, torch.float32, "C=3"), (3, 52, torch.float32, "F<=51"),
    (3, 5, torch.float64, "float32")])
def test_kernel_shapes_refuse_what_the_kernels_do_not_take(c, f, dtype,
                                                          match):
    inp, kv = _meta(1, c, 4, 5, f, dtype)
    with pytest.raises(ValueError, match=match):
        sc._kernel_shapes(inp, kv, kv)


def test_kernel_shapes_refuse_a_map_of_another_size():
    inp, kv = _meta(2, 3, 4, 5, 7)
    with pytest.raises(ValueError, match="does not match"):
        sc._kernel_shapes(inp, kv, kv[:1])


def test_sepconv_is_twice_differentiable_gradgradcheck():
    """gradgradcheck in float64: the backward of the backward
    (SepConvGradKernelsFunction) against finite differences, with the
    input and both kernel maps requiring grad."""
    inp, kv, kh, _ = _data(1, 4, 5, 5, seed=20)
    args = [_t(x).double().requires_grad_() for x in (inp, kv, kh)]
    assert torch.autograd.gradcheck(sc.sepconv, args)
    assert torch.autograd.gradgradcheck(sc.sepconv, args)


@pytest.mark.parametrize("input_grad", [False, True])
def test_double_backward_matches_autograd_of_plain_forward(input_grad):
    """F = 51 on a 3x4 map: vector-Jacobian products of the first
    gradients (w.r.t. g, kv, kh and the input) built from the kernels'
    plain versions, against autograd twice through sepconv_ref."""
    inp, kv, kh, g = _data(1, 3, 4, 51, seed=21)
    rs = np.random.RandomState(22)
    a_in = torch.from_numpy(rs.randn(1, 3, 53, 54).astype(np.float32))
    a_kv, a_kh = (_t(rs.randn(1, 3, 4, 51).astype(np.float32))
                  for _ in range(2))

    def second(fn):
        i = _t(inp).requires_grad_(input_grad)
        v, hh = _t(kv).requires_grad_(), _t(kh).requires_grad_()
        tg = _t(g).requires_grad_()
        first = torch.autograd.grad(fn(i, v, hh), [i, v, hh] if input_grad
                                    else [v, hh], tg, create_graph=True)
        cot = ([a_in] if input_grad else []) + [a_kv, a_kh]
        wrt = [tg, v, hh] + ([i] if input_grad else [])
        return torch.autograd.grad(first, wrt, cot)

    sc.reset_launches()
    got = second(sc.sepconv)
    assert sc.sepconv_forward.launches == 0     # CPU: plain versions
    want = second(sc.sepconv_ref)
    for a, b, name in zip(got, want, ("g", "kv", "kh", "inp")):
        torch.testing.assert_close(a, b, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   msg=name)
