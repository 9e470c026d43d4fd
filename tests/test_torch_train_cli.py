"""The port's training command line on the CPU: ``--mode train`` runs an
epoch of SepConv meta-training, validates, writes ``checkpoint.pth`` and
``model_best.pth``, and ``--resume`` reads them back. A file of its own so
that it runs beside the evaluation CLI's JAX comparison
(``--dist loadfile``)."""
import pytest
import torch

from meta_interpolation_tpu_torch.core.checkpoint import load_checkpoint
from meta_interpolation_tpu_torch.main import main
from meta_interpolation_tpu_torch.meta.system import SceneAdaptiveInterpolation


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this file's PyTorch work: the tier-1 run
    puts six test processes on the machine's cores, where every process
    taking a thread a core oversubscribes them many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _train_argv(ckpt_dir):
    # SGD with fixed LSLR rates: the checkpoint is the net and little else
    # (87 MB); tests/test_torch_train.py checkpoints Adamax's moments
    return ["--model", "sepconv", "--mode", "train", "--dataset", "synthetic",
            "--crop_size", "32", "--optimizer", "SGD",
            "--inner_lr", "1e-5", "--outer_lr", "1e-5", "--loss", "1*L1",
            "--batch_size", "1", "--val_batch_size", "1",
            "--number_of_training_steps_per_iter", "1",
            "--number_of_evaluation_steps_per_iter", "1",
            "--checkpoint_dir", str(ckpt_dir), "--exp_name", "train_cli",
            "--device", "cpu"]


def test_cli_trains_checkpoints_and_resumes(tmp_path, capsys, monkeypatch):
    exp = tmp_path / "train_cli"
    iters = []
    real = SceneAdaptiveInterpolation.run_train_iter
    monkeypatch.setattr(SceneAdaptiveInterpolation, "run_train_iter",
                        lambda self, *a, **k: iters.append(a[1])
                        or real(self, *a, **k))
    got = main(_train_argv(tmp_path) + ["--max_epoch", "1",
                                        "--total_iter_per_epoch", "2"])
    out = capsys.readouterr().out
    assert "[epoch 0 it 0] loss" in out and "[val epoch 0]" in out
    assert sorted(p.name for p in exp.iterdir()) == ["checkpoint.pth",
                                                     "model_best.pth"]
    state = load_checkpoint(str(exp))
    assert state["epoch"] == 1 and state["best_PSNR"] == got["best_psnr"]
    assert state["arch"]["model"] == "sepconv"
    assert iters == [0, 0]
    # SGD keeps no moments: the optimizer's state is its rate
    assert state["system"]["opt_state"]["state"] == {}
    assert state["system"]["opt_state"]["param_groups"][0]["lr"] == 1e-5

    # the run is complete at --max_epoch 1: resuming reads the checkpoint
    # and trains no further (tests/test_torch_train.py holds a resumed
    # run's next iteration bit-equal to an uninterrupted one)
    again = main(_train_argv(tmp_path) + ["--max_epoch", "1", "--resume"])
    out = capsys.readouterr().out
    assert f"[resume] epoch 1, best PSNR {got['best_psnr']:.2f}" in out
    assert "[epoch" not in out and again == got
    assert iters == [0, 0]
    assert load_checkpoint(str(exp))["epoch"] == 1
    for path in tmp_path.rglob("*.pth"):   # weights read: free the disk
        path.unlink()
