"""CAIN's reflection pad under ``torch.use_deterministic_algorithms``
(``models/layers.ReflectPadFunction``): the same values as
``F.pad(mode="reflect")``, the same gradients up to the order of their
sums, twice differentiable, and taken only in that mode.

On the card aten's backward of the pad adds with atomics and refuses to
run in that mode; there chip_smoke.py runs CAIN's bf16 card-vs-CPU clip
twice and holds the two runs bit for bit equal. Here on the CPU the tests
hold the function's arithmetic: values bit for bit, gradients within 1e-12
in float64 (a corner of the pad sums four cotangents, in another order
than aten's) and by gradcheck / gradgradcheck.
"""
import pytest
import torch
import torch.nn.functional as F

from meta_interpolation_tpu_torch.models import cain, layers


pytestmark = pytest.mark.usefixtures("two_threads")


@pytest.fixture(scope="module")
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def deterministic_algorithms():
    saved = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(saved)


@pytest.mark.parametrize("p,hw", [(1, (5, 7)), (2, (6, 9)), (1, (2, 3))])
def test_reflect_pad_function_matches_f_pad(p, hw):
    gen = torch.Generator().manual_seed(p + hw[0])
    x = torch.randn(2, 3, *hw, dtype=torch.float64, generator=gen,
                    requires_grad=True)
    g = torch.randn(2, 3, hw[0] + 2 * p, hw[1] + 2 * p, dtype=torch.float64,
                    generator=gen)
    got = layers.ReflectPadFunction.apply(x, p)
    want = F.pad(x, (p,) * 4, mode="reflect")
    assert torch.equal(got, want)
    (g_got,) = torch.autograd.grad(got, x, g)
    (g_want,) = torch.autograd.grad(want, x, g)
    torch.testing.assert_close(g_got, g_want, rtol=0, atol=1e-12)


def test_reflect_pad_function_is_twice_differentiable():
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(1, 2, 4, 5, dtype=torch.float64, generator=gen,
                    requires_grad=True)
    fn = lambda t: layers.ReflectPadFunction.apply(t, 1)  # noqa: E731
    assert torch.autograd.gradcheck(fn, (x,))
    assert torch.autograd.gradgradcheck(fn, (x,))


def test_reflect_pad_same_takes_the_function_only_in_deterministic_mode(
        deterministic_algorithms):
    x = torch.randn(1, 1, 4, 4, requires_grad=True)
    assert type(layers.reflect_pad_same(x, 1).grad_fn).__name__ == (
        "ReflectPadFunctionBackward")
    torch.use_deterministic_algorithms(False)
    assert "ReflectionPad2D" in type(layers.reflect_pad_same(
        x, 1).grad_fn).__name__


def test_cain_in_deterministic_mode_matches_and_repeats(
        deterministic_algorithms):
    """A tiny CAIN's prediction and weight gradients: bit for bit the same
    in two runs under the mode, and the default mode's within 1e-6."""
    net = cain.CAIN(torch.Generator().manual_seed(0), depth=2, n_resgroups=2,
                    n_resblocks=2, reduction=4, pad_multiple=8)
    gen = torch.Generator().manual_seed(1)
    frames = [torch.rand(1, 3, 16, 24, generator=gen) for _ in range(2)]

    def run():
        net.zero_grad()
        out = net(*frames)
        out.square().mean().backward()
        return out.detach(), [p.grad.clone() for p in net.parameters()]

    first, again = run(), run()
    torch.use_deterministic_algorithms(False)
    default = run()
    assert torch.equal(first[0], again[0]) and torch.equal(first[0],
                                                          default[0])
    for a, b, c in zip(first[1], again[1], default[1]):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, c, rtol=1e-6, atol=1e-6)
