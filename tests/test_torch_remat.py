"""``--remat``: every model forward of an episode under
``torch.utils.checkpoint``, its activations recomputed in its backward
(JAX ``jax.checkpoint`` of the apply, meta/system.py:306-309). The values
and outer gradients are those without it; the forward kernels run once
more for each recomputed forward."""
import numpy as np
import pytest
import torch

from meta_interpolation_tpu_torch.config import Config
from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
from meta_interpolation_tpu_torch.meta import system
from meta_interpolation_tpu_torch.ops import sepconv as sc

# second order: each group's outer gradient within this share of its norm
# (the recomputed graph accumulates the double backward in another order;
# at the inner SGD rule that rounding stays rounding, where Adam's first
# step, ~lr·sign(g), turns it into a flip of elements whose gradient is
# within rounding of zero)
SECOND_ORDER_RTOL = 1e-6
CAIN = dict(model="cain", depth=2, n_resblocks=1, crop_size=32,
            mode="train", batch_size=1, metasgd=True,
            number_of_training_steps_per_iter=1, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _frames(model, hw=(32, 32)):
    return np.asarray(SyntheticSeptuplet(model=model, mode="train",
                                         size=hw)[0][0])[None]


def _outer(remat, **kw):
    tsys = system.SceneAdaptiveInterpolation(Config(**{**CAIN, **kw},
                                                    remat=remat))
    assert tsys.builder.remat == remat
    loss, aux, grads = tsys.outer_grads(_frames("cain"), 0)
    return float(loss), aux["preds"], grads


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("order", ["first", "second"])
def test_remat_leaves_values_and_gradients(order, dtype):
    kw = dict(dtype=dtype, optimizer="Adam" if order == "first" else "SGD",
              second_order=order == "second")
    l0, p0, g0 = _outer(False, **kw)
    l1, p1, g1 = _outer(True, **kw)
    assert l0 == l1 and torch.equal(p0, p1)
    for group in g0:
        if order == "first":
            for k, v in g0[group].items():
                assert torch.equal(v, g1[group][k]), (group, k)
            continue
        diff = sum(float((v - g1[group][k]).norm()) ** 2
                   for k, v in g0[group].items()) ** 0.5
        ref = sum(float(v.norm()) ** 2 for v in g0[group].values()) ** 0.5
        assert diff <= SECOND_ORDER_RTOL * ref, (group, diff, ref)


def test_remat_recomputes_each_forward_in_its_backward(monkeypatch):
    """SepConv's K1 and K2 calls (their plain versions on the CPU, counted)
    with and without --remat, 1 inner step: K1 rises by the sepconv calls
    of the recomputed forwards (first order: every support pass and the
    training query once; second order: each support pass in the inner
    gradient and again in the outer backward, the query once;
    evaluation: the support passes), K2 does not."""
    calls = {"k1": 0, "k2": 0}
    k1, k2 = sc.sepconv_ref, sc.grad_kernels_ref
    monkeypatch.setattr(sc, "sepconv_ref", lambda *a: calls.__setitem__(
        "k1", calls["k1"] + 1) or k1(*a))
    monkeypatch.setattr(sc, "grad_kernels_ref", lambda *a: calls.__setitem__(
        "k2", calls["k2"] + 1) or k2(*a))
    steps, pairs, per_forward = 1, 2, 2
    support = steps * pairs * per_forward
    frames = _frames("sepconv", (16, 16))
    counts = {}
    for remat in (False, True):
        for second in (False, True):
            tsys = system.SceneAdaptiveInterpolation(Config(
                model="sepconv", mode="train", batch_size=1, crop_size=16,
                optimizer="Adamax", metasgd=True, device="cpu",
                number_of_training_steps_per_iter=steps,
                number_of_evaluation_steps_per_iter=steps,
                second_order=second, remat=remat))
            calls.update(k1=0, k2=0)
            tsys.outer_grads(frames, 0)
            counts[remat, second, "train"] = dict(calls)
            calls.update(k1=0, k2=0)
            tsys.run_validation_iter(frames)
            counts[remat, second, "eval"] = dict(calls)
    import chip_smoke
    for second in (False, True):
        extra = ((2 * support if second else support) + per_forward)
        # the launches chip_smoke.py holds the card to
        assert chip_smoke.remat_extra(steps, per_forward, second) == extra
        base = counts[False, second, "train"]
        assert counts[True, second, "train"] == {
            "k1": base["k1"] + extra, "k2": base["k2"]}
        base = counts[False, second, "eval"]
        assert base == {"k1": support + per_forward, "k2": support}
        assert counts[True, second, "eval"] == {"k1": base["k1"] + support,
                                                "k2": base["k2"]}
    assert chip_smoke.remat_extra(steps, per_forward, False,
                                  training=False) == support
    assert counts[False, False, "train"] == {"k1": support + per_forward,
                                             "k2": support + per_forward}
