"""``--profile_dir``, ``--use_tensorboard`` and ``--lpips`` through the
port's CLI on the CPU, with the SSIM and VGG19 terms in the loss, and the
profiling helpers (utils/profiling.py)."""
import builtins
import json

import pytest
import torch

from meta_interpolation_tpu_torch.main import main
from meta_interpolation_tpu_torch.utils import profiling

# a tiny CAIN: the SepConv path of these flags is driven on the chip
TINY = ["--model", "cain", "--depth", "2", "--n_resblocks", "1",
        "--dataset", "synthetic", "--crop_size", "32", "--optimizer", "Adam",
        "--metasgd", "--inner_lr", "1e-5", "--device", "cpu"]
VAL = TINY + ["--mode", "val", "--number_of_evaluation_steps_per_iter", "1"]
TRAIN = TINY + ["--mode", "train", "--batch_size", "1", "--loss", "1*L1",
                "--max_epoch", "1", "--total_iter_per_epoch", "2",
                "--log_iter", "1"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def isolated(monkeypatch, tmp_path):
    """No VGG or LPIPS weights on the search path; LPIPS loads afresh."""
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("MIT_VGG_WEIGHTS", raising=False)
    monkeypatch.setattr(profiling, "_LPIPS_PARAMS", None)
    return tmp_path


def _scalars(log_dir):
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator)
    acc = EventAccumulator(str(log_dir))
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
            for tag in acc.Tags()["scalars"]}


def test_val_cli_with_vgg_ssim_lpips_trace_and_tensorboard(isolated, capsys):
    out = main(VAL + ["--loss", "1*L1+0.1*VGG22+1*SSIM", "--lpips",
                      "--use_tensorboard", "--log_dir", "logs",
                      "--profile_dir", "prof", "--val_batch_size", "2"])
    text = capsys.readouterr()
    line = [ln for ln in text.out.splitlines()
            if ln.startswith("[val epoch 0]")]
    assert len(line) == 1 and " LPIPS " in line[0]
    assert 0 < out["lpips"] < 10 and out["psnr"] > 0
    assert "no pretrained vgg19 weights" in text.err
    assert "LPIPS runs on RANDOM-INIT" in text.err
    trace = json.loads((isolated / "prof" / profiling.TRACE_FILE).read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("conv" in n for n in names)
    scalars = _scalars(isolated / "logs" / "exp")
    assert set(scalars) == {"Loss/val", "PSNR", "SSIM"}
    assert scalars["PSNR"] == [(0, pytest.approx(out["psnr"]))]


def test_train_cli_logs_the_train_loss(isolated, capsys):
    main(TRAIN + ["--use_tensorboard", "--log_dir", "logs",
                  "--checkpoint_dir", "ck"])
    scalars = _scalars(isolated / "logs" / "exp")
    assert [s for s, _ in scalars["Loss/train"]] == [0, 1]
    assert [s for s, _ in scalars["Loss/val"]] == [0]
    for path in isolated.rglob("*.pth"):
        path.unlink()


def test_tensorboard_missing_disables_logging(isolated, capsys,
                                              monkeypatch):
    real = builtins.__import__

    def no_tensorboard(name, *args, **kwargs):
        if name == "torch.utils.tensorboard":
            raise ImportError("no tensorboard")
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_tensorboard)
    main(VAL + ["--loss", "1*L1", "--use_tensorboard", "--log_dir", "logs"])
    assert ("[tb] tensorboard unavailable — logging disabled"
            in capsys.readouterr().out)
    assert not (isolated / "logs").exists()


def test_trace_annotate_and_step_timer(tmp_path):
    with profiling.trace(None) as nothing:
        assert nothing is None
    with profiling.trace(str(tmp_path), cuda=False):
        with profiling.annotate("my_region"):
            torch.ones(8).sum()
    trace = json.loads((tmp_path / profiling.TRACE_FILE).read_text())
    assert "my_region" in {e.get("name") for e in trace["traceEvents"]}
    timer = profiling.StepTimer()
    timer.start()
    assert timer.stop({"a": [torch.ones(3)]}) >= 0
    timer.start()
    timer.stop()
    assert len(timer.times) == 2 and timer.mean >= 0
