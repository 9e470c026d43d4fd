"""The port's SuperSloMo scene-adaptive evaluation held against the JAX
system on the CPU: run_superslomo.sh (Adam, Meta-SGD, 1*Super, 1 + 1
steps) with --fast_warp_range 4 and as it is (the exact warp); the CLI,
in evaluation and in training (first and second order, and in bf16), and
the training flags it refuses. The presets, helpers and tolerances are
tests/test_torch_warp_models_episode.py's, where VoxelFlow's cases run;
each file runs in a test process of its own. The JAX episodes run op by
op (``jit_episode=False``), the exact one first, so the bounded one reuses
its compiled primitives.
"""
import pytest

from test_torch_warp_models_episode import (  # noqa: F401 (one_thread)
    hold_preset_to_jax, refuse_training, run_cli_on_the_cpu,
    train_bf16_on_the_cpu, train_cli_on_the_cpu, one_thread)

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("model,warp_range", [("superslomo", 0),
                                              ("superslomo", 4)])
def test_run_validation_iter_matches_jax(model, warp_range):
    hold_preset_to_jax(model, warp_range)


@pytest.mark.parametrize("model,eval_steps", [("superslomo", 0)])
def test_cli_val_runs_on_the_cpu(model, eval_steps, tmp_path, capsys):
    run_cli_on_the_cpu(model, eval_steps, tmp_path, capsys)


@pytest.mark.parametrize("model", ["superslomo"])
def test_training_is_refused(model, tmp_path):
    """Meta-training runs since the port's training slice of the warp
    models; what stays refused is refused."""
    refuse_training(model, tmp_path)


@pytest.mark.parametrize("order", ["first", "second"])
def test_cli_trains_superslomo_on_the_cpu(order, tmp_path, capsys):
    train_cli_on_the_cpu("superslomo", order, tmp_path, capsys)


@pytest.mark.parametrize("model", ["superslomo"])
def test_cli_trains_in_bf16(model, tmp_path, capsys):
    train_bf16_on_the_cpu(model, tmp_path, capsys)
