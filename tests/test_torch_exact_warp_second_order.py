"""The exact warp's second derivative (``ops/warp.GridSampleFunction``) on
the CPU: values and first-order gradients bitwise those of
``F.grid_sample``; second-order gradients against torch's native double
backward (torch 2.13 on the CPU has one; the card's torch 2.11 does not);
the closed form of the sampler's gradients against aten's backward; and
second-order training going through the port's derivative. JAX's
second-order outer gradient through the exact warp is held in
tests/test_torch_warp_train.py (``[second-0]``) and
tests/test_torch_rrin_train_second_order.py.

Limits: float64, 1e-10 of the largest value (the native double backward
and the closed form sum the same taps in another order; measured 1e-13).
"""
import itertools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from meta_interpolation_tpu_torch.config import Config
from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
from meta_interpolation_tpu_torch.meta.system import (
    SceneAdaptiveInterpolation)
from meta_interpolation_tpu_torch.ops import warp


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


CASES = list(itertools.product(("zeros", "border"), (False, True)))
RTOL = 1e-10


def inputs(dtype, seed=0):
    """An image, a grid reaching past every edge (|g| up to 1.3) and an
    output cotangent, all requiring grad."""
    gen = torch.Generator().manual_seed(seed)
    img = torch.randn(2, 3, 7, 9, generator=gen, dtype=dtype)
    grid = torch.rand(2, 5, 6, 2, generator=gen, dtype=dtype) * 2.6 - 1.3
    g = torch.randn(2, 3, 5, 6, generator=gen, dtype=dtype)
    return [t.requires_grad_(True) for t in (img, grid, g)]


def native(img, grid, align_corners, padding_mode):
    return F.grid_sample(img, grid, mode="bilinear",
                         padding_mode=padding_mode,
                         align_corners=align_corners)


@pytest.mark.parametrize("padding_mode,align_corners", CASES)
def test_values_and_first_order_are_bitwise_the_library(padding_mode,
                                                        align_corners):
    img, grid, g = inputs(torch.float32)
    outs = []
    for fn in (native, warp.grid_sample):
        out = fn(img, grid, align_corners, padding_mode)
        outs.append((out,) + torch.autograd.grad(out, (img, grid), g))
    for got, want in zip(*outs):
        assert torch.equal(got, want)


@pytest.mark.parametrize("padding_mode,align_corners", CASES)
def test_second_order_matches_the_native_double_backward(padding_mode,
                                                         align_corners):
    """A scalar of both first-order gradients, differentiated again with
    respect to the image, the grid and the cotangent."""
    img, grid, g = inputs(torch.float64, seed=1)
    got = []
    for fn in (native, warp.grid_sample):
        out = fn(img, grid, align_corners, padding_mode)
        g_img, g_grid = torch.autograd.grad(out, (img, grid), g,
                                            create_graph=True)
        loss = (g_img * torch.cos(img)).sum() + (g_grid ** 2).sum()
        got.append(torch.autograd.grad(loss, (img, grid, g)))
    for mine, ref in zip(got[1], got[0]):
        torch.testing.assert_close(mine, ref, rtol=0,
                                   atol=RTOL * float(ref.abs().max()))


@pytest.mark.parametrize("padding_mode,align_corners", CASES)
def test_closed_form_gradients_match_aten(padding_mode, align_corners):
    img, grid, g = (t.detach() for t in inputs(torch.float64, seed=2))
    want = torch.ops.aten.grid_sampler_2d_backward(
        g, img, grid, 0, warp._ATEN_PADDING[padding_mode], align_corners,
        [True, True])
    got = warp.grid_sample_grads_ref(g, img, grid, align_corners,
                                     padding_mode)
    for mine, ref in zip(got, want):
        torch.testing.assert_close(mine, ref, rtol=0,
                                   atol=RTOL * float(ref.abs().max()))


def test_third_order_is_refused():
    """A second derivative taken with create_graph (the way to a third)
    raises instead of returning one that would be wrong."""
    img, grid, g = inputs(torch.float64)
    out = warp.grid_sample(img, grid)
    g_grid, = torch.autograd.grad(out, grid, g, create_graph=True)
    with pytest.raises(NotImplementedError, match="twice differentiable"):
        torch.autograd.grad((g_grid ** 2).sum(), grid, create_graph=True)


def test_second_order_training_takes_the_ports_derivative(monkeypatch):
    """VoxelFlow's second-order outer gradient on the exact warp runs the
    derivative of GridSampleBackwardFunction, once a support warp (two
    warps a forward, two support pairs), and gives a finite gradient."""
    calls = []
    real = warp.GridSampleBackwardFunction.backward
    monkeypatch.setattr(warp.GridSampleBackwardFunction, "backward",
                        staticmethod(lambda ctx, *v: calls.append(1)
                                     or real(ctx, *v)))
    system = SceneAdaptiveInterpolation(Config(
        model="voxelflow", loss="1*MSE", optimizer="SGD", metasgd=True,
        inner_lr=1e-3, number_of_training_steps_per_iter=1,
        crop_size=32, mode="train", batch_size=1, second_order=True,
        device="cpu"))
    frames = np.asarray(SyntheticSeptuplet(model="voxelflow", mode="train",
                                           size=(32, 32))[0][0])[None]
    loss, _, grads = system.outer_grads(frames, 0)
    assert len(calls) == 2 * 2
    assert np.isfinite(float(loss))
    assert float(grads["net"]["conv1.weight"].norm()) > 0
