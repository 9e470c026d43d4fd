"""The six models under --dtype bfloat16, held on the CPU against the JAX
package's jitted apply through its own ``bf16_apply``
(``meta_interpolation_tpu/meta/system.py:311-323``, built here by the
system's ``_apply_fn``): the frames cast to bf16, every layer casting its
float32 weights to the activation's type, the prediction cast back.

The port runs each model two ways: served, with every weight in bf16 as
``bench.py`` serves them (``model.to(torch.bfloat16)``); and as the
episode runs it (``EpisodeBuilder._forward`` with ``dtype`` bf16: the
weights cast on the tape from their float32 masters), for the prediction
and the gradient of Σ g·pred with respect to the parameters.

JAX's CPU fallbacks of its two TPU kernels round otherwise than the
kernels (``sepconv_ref`` and ``_warp_bounded_xla`` sum in bf16), so the
JAX side runs with both routed to the kernels' function, as on a TPU:
``_sepconv_fwd_impl`` → ``sepconv_ref`` on the widened inputs, rounded
once (``_pallas_forward``'s function), and ``_warp_bounded_xla`` → the
sweep on the widened image and fractions, rounded once
(``warp_bounded_pallas``'s); tests/test_torch_bf16_ops.py holds both
functions to the interpret-mode kernels. The sepconv op's backward stays
JAX's CPU one.

Tolerance, bf16 itself: |port − JAX bf16| ≤ 2·|JAX bf16 − JAX float32| +
1e-5·max|JAX bf16|, in max norm, on the prediction and on each parameter
group's gradient (the parameters under one top-level module): the port
may stray no further from JAX than bf16 puts JAX from its own float32.
"""
import copy
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meta_interpolation_tpu.meta.system import (
    SceneAdaptiveInterpolation as JaxSystem)
from meta_interpolation_tpu.models import registry as jax_registry
from meta_interpolation_tpu.ops import sepconv as jax_sc
from meta_interpolation_tpu.ops import warp as jax_warp
from meta_interpolation_tpu_torch.core import checkpoint as bridge
from meta_interpolation_tpu_torch.meta.episode import EpisodeBuilder, TaskState
from meta_interpolation_tpu_torch.models import cain, rrin, sepconv, voxelflow

FLOOR = 1e-5
HW = (32, 32)
CAIN_TINY = dict(depth=2, n_resgroups=2, n_resblocks=2, reduction=4)

pytestmark = pytest.mark.usefixtures("one_thread", "tpu_kernels")


@pytest.fixture(scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tpu_sepconv(inp, kv, kh, use_pallas, _ref=jax_sc.sepconv_ref):
    f32 = jnp.float32
    return _ref(inp.astype(f32), kv.astype(f32), kh.astype(f32)
                ).astype(inp.dtype)


def _tpu_sweep(img, dy0, dx0, fy, fx, r, _xla=jax_warp._warp_bounded_xla):
    f32 = jnp.float32
    return _xla(img.astype(f32), dy0, dx0, fy.astype(f32), fx.astype(f32),
                r).astype(img.dtype)


@pytest.fixture(scope="module")
def tpu_kernels():
    """The JAX ops on their TPU kernels' function for the whole file."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_sc, "_sepconv_fwd_impl", _tpu_sepconv)
    mp.setattr(jax_warp, "_warp_bounded_xla", _tpu_sweep)
    yield
    mp.undo()


def jax_apply(name, dtype, **model_kwargs):
    """JAX's model apply as its meta system runs it under ``--dtype``
    (``_apply_fn``: bf16_apply for bfloat16), jitted."""
    ns = SimpleNamespace(model_def=jax_registry.get(name),
                         model_kwargs=model_kwargs,
                         cfg=SimpleNamespace(remat=False, dtype=dtype))
    apply = JaxSystem._apply_fn(ns)
    return jax.jit(lambda p, a, b: apply(p, a, b))


def _first(out):
    return out[0] if isinstance(out, tuple) else out


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def hold(port, jax_bf16, jax_f32, what):
    """The bf16 rule, in max norm; returns (error, limit)."""
    jb, jf = np.asarray(jax_bf16, np.float32), np.asarray(jax_f32, np.float32)
    err = float(np.abs(np.asarray(port, np.float32) - jb).max())
    lim = (2 * float(np.abs(jb - jf).max())
           + FLOOR * float(np.abs(jb).max()))
    assert err <= lim, f"{what}: |port − JAX bf16| {err:.3e} > {lim:.3e}"
    return err, lim


def frames(hw=HW, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.rand(1, *hw, 3).astype(np.float32) for _ in range(2)]


def port_model(cls, jax_params, **kwargs):
    model = cls(None, **kwargs)
    model.load_state_dict(bridge.params_from_jax(jax_params, model))
    return model


def served_bf16(model, f0, f1, **fwd_kw):
    """The model with every weight in bf16 on bf16 frames, as float32."""
    net = copy.deepcopy(model).to(torch.bfloat16)
    with torch.no_grad():
        out = net(_nchw(f0).bfloat16(), _nchw(f1).bfloat16(), **fwd_kw)
    return _first(out).float()


def check_forward(name, model, jax_params, f0, f1, model_kwargs=None,
                  fwd_kw=None):
    """The served bf16 prediction against JAX's bf16_apply."""
    kw = dict(model_kwargs or {}, **(fwd_kw or {}))
    a, b = jnp.asarray(f0), jnp.asarray(f1)
    want = {d: np.asarray(_first(jax_apply(name, d, **kw)(jax_params, a, b)))
            for d in ("float32", "bfloat16")}
    got = served_bf16(model, f0, f1, **(fwd_kw or {}))
    assert got.shape == (1, 3) + f0.shape[1:3]
    return hold(_nhwc(got), want["bfloat16"], want["float32"],
                f"{name} prediction")


def check_vjp(name, model, jax_params, f0, f1, model_kwargs=None,
              apply_kwargs=None, groups=None):
    """The prediction and the gradient of Σ g·pred at the parameters, the
    port through the episode's bf16 forward, against jax.vjp of
    bf16_apply; the gradient held per group of parameters under one
    top-level module: every group, or those of ``groups`` (the others
    take no gradient on either side)."""
    kw = dict(model_kwargs or {}, **(apply_kwargs or {}))
    g = np.random.RandomState(7).randn(*f0.shape).astype(np.float32)
    a, b = jnp.asarray(f0), jnp.asarray(f1)
    sub = {k: v for k, v in jax_params.items()
           if groups is None or k in groups}
    want, want_pred = {}, {}
    for dtype in ("float32", "bfloat16"):
        apply = jax_apply(name, dtype, **kw)
        pred, vjp = jax.vjp(
            lambda s: _first(apply({**jax_params, **s}, a, b)), sub)
        grads, = vjp(jnp.asarray(g))
        full = {**jax.tree.map(np.zeros_like, jax_params),
                **jax.tree.map(np.asarray, grads)}
        want[dtype] = bridge.params_from_jax(full, model)
        want_pred[dtype] = np.asarray(pred)
    builder = EpisodeBuilder(model, None, None, apply_kwargs=apply_kwargs)
    builder.dtype = torch.bfloat16
    params = {k: v.detach().clone().requires_grad_(
        groups is None or k.split(".")[0] in groups)
        for k, v in model.named_parameters()}
    out = builder._forward(params, _nchw(f0)[0], _nchw(f1)[0], 0,
                           TaskState())
    pred = _first(out)
    assert pred.dtype == torch.float32
    hold(_nhwc(pred), want_pred["bfloat16"], want_pred["float32"],
         f"{name} episode prediction")
    (pred * _nchw(g)).sum().backward()
    by_group = {}
    for k, p in params.items():
        if p.requires_grad:
            assert p.grad is not None and p.grad.dtype == torch.float32, k
            by_group.setdefault(k.split(".")[0], []).append(k)
    assert by_group
    for group, keys in by_group.items():
        cat = lambda src: np.concatenate(
            [np.asarray(src[k], np.float32).ravel() for k in keys])
        hold(cat({k: params[k].grad.numpy() for k in keys}),
             cat(want["bfloat16"]), cat(want["float32"]),
             f"{name} gradient of {group}")


@pytest.fixture(scope="module")
def sepconv_params():
    return jax.tree.map(np.asarray, jax_registry.get("sepconv").init(
        jax.random.PRNGKey(0)))


def test_sepconv_bf16_forward_and_vjp(sepconv_params):
    model = port_model(sepconv.SepConv, sepconv_params)
    f0, f1 = frames()
    check_forward("sepconv", model, sepconv_params, f0, f1)
    check_vjp("sepconv", model, sepconv_params, f0, f1)


@pytest.mark.parametrize("warp_range", [None, 4])
def test_voxelflow_bf16_forward_and_vjp(warp_range):
    from test_torch_voxelflow_model import _jax_params
    params = _jax_params()
    model = port_model(voxelflow.VoxelFlow, params, warp_range=warp_range)
    f0, f1 = (x * 2 - 1 for x in frames(seed=1))
    kw = {"warp_range": warp_range} if warp_range else {}
    check_forward("voxelflow", model, params, f0, f1, kw)
    check_vjp("voxelflow", model, params, f0, f1, kw)


@pytest.fixture(scope="module")
def cain_params():
    return jax.tree.map(np.asarray, jax_registry.get("cain").init(
        jax.random.PRNGKey(3), **CAIN_TINY))


@pytest.mark.parametrize("serving", [False, True])
def test_cain_bf16_forward_and_vjp(cain_params, serving):
    """The meta system's CAIN (reflect pads to ×128) and bench.py's serving
    options (pad_multiple 8, fuse_pad): both bf16 on every weight."""
    opts = ({"pad_multiple": 8, "fuse_pad": True} if serving
            else {"pad_multiple": 128, "fuse_pad": False})
    model = port_model(cain.CAIN, cain_params, **CAIN_TINY, **opts)
    f0, f1 = frames((20, 28), seed=2)
    kw = dict(depth=2, n_resgroups=2, n_resblocks=2, **opts)
    check_forward("cain", model, cain_params, f0, f1, kw)
    if not serving:
        check_vjp("cain", model, cain_params, f0, f1, kw)


@pytest.fixture(scope="module")
def rrin_params():
    return jax.tree.map(np.asarray, jax_registry.get("rrin").init(
        jax.random.PRNGKey(0)))


@pytest.mark.parametrize("warp_range", [None, 4])
def test_rrin_bf16_forward_and_vjp(rrin_params, warp_range):
    model = port_model(rrin.RRIN, rrin_params, warp_range=warp_range)
    f0, f1 = frames(seed=3)
    kw = {"warp_range": warp_range} if warp_range else {}
    check_forward("rrin", model, rrin_params, f0, f1, kw)
    if warp_range:
        check_vjp("rrin", model, rrin_params, f0, f1, kw)
