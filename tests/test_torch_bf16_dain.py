"""DAIN under --dtype bfloat16, held on the CPU against the JAX package's
jitted apply through its own ``bf16_apply``, as
tests/test_torch_bf16_models.py holds the other models (its helpers, its
JAX ops on their TPU kernels' function, its rule: |port − JAX bf16| ≤
2·|JAX bf16 − JAX float32| + 1e-5·max|JAX bf16| in max norm), with the
tamed random weights of tests/test_torch_dain_model.py.

DAIN's bf16 forward takes other projection floors and filter taps than
its float32 one wherever a flow lies within bf16's rounding of a cell
boundary, so its gap is large and the rule loose. The served forward runs
K4's path (``proj_range=8, fill_holes=True``, as ``bench.py``), the meta
forward the exact projection with hole filling, its gradient held at the
rectify net, the one subnet meta-training trains (JAX's vjp taken at it
alone: the whole network's backward compiles for minutes).
"""
import pytest

from meta_interpolation_tpu_torch.models.dain.model import DAIN
from test_torch_bf16_models import (  # noqa: F401 (fixtures)
    check_forward, check_vjp, frames, port_model, tpu_kernels, one_thread)
from test_torch_dain_model import _tamed_jax_params

pytestmark = pytest.mark.usefixtures("one_thread", "tpu_kernels")


@pytest.fixture(scope="module")
def dain_params():
    return _tamed_jax_params()


def test_dain_bf16_served_forward(dain_params):
    model = port_model(DAIN, dain_params)
    f0, f1 = frames(seed=5)
    check_forward("dain", model, dain_params, f0, f1,
                  fwd_kw={"proj_range": 8, "fill_holes": True})


def test_dain_bf16_meta_forward_and_vjp(dain_params):
    model = port_model(DAIN, dain_params)
    f0, f1 = frames(seed=5)
    check_vjp("dain", model, dain_params, f0, f1,
              apply_kwargs={"fill_holes": True}, groups=("rectifyNet",))
