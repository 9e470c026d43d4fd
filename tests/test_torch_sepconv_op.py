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


@pytest.mark.parametrize("n,h,w,f", [(2, 6, 7, 5), (1, 5, 9, 51)])
def test_plain_forward_matches_jax_ref(n, h, w, f):
    inp, kv, kh, _ = _data(n, h, w, f, seed=f)
    expected = jax_sc.sepconv_ref(jnp.asarray(inp), jnp.asarray(kv),
                                  jnp.asarray(kh))
    got = sc.sepconv_forward(_t(inp), _t(kv), _t(kh))
    np.testing.assert_allclose(_np(got), np.asarray(expected), rtol=FWD_RTOL)


@pytest.mark.parametrize("n,h,w,f", [(1, 4, 5, 3), (1, 3, 4, 51)])
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
