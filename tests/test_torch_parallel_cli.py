"""The port's CLI under ``torchrun`` on the CPU: one tiny-CAIN training
epoch of 2 iterations at batch 4 on 2 gloo ranks (``--mesh_shape 2``),
held against a one-process run, and ``--episode_parallel false``, under
which rank 0 runs alone and rank 1 leaves idle.

Every rank runs with one intra-op thread (``torchrun`` sets
OMP_NUM_THREADS=1 for several ranks) and so does the one-process run, so
only the order of the outer gradient's sum over tasks differs: the
weights are held within 1e-5 of each tensor's norm (the Meta-SGD rates,
which move by ~lr·sign(g) a step, of their group's); the idle path runs
the one-process computation and is held bit for bit.
"""
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from meta_interpolation_tpu_torch.main import main

ROOT = pathlib.Path(__file__).resolve().parents[1]
FLAGS = ["--model", "cain", "--depth", "2", "--n_resblocks", "1",
         "--crop_size", "32", "--mode", "train", "--dataset", "synthetic",
         "--batch_size", "4", "--val_batch_size", "1", "--loss", "1*L1",
         "--optimizer", "Adam", "--metasgd", "--inner_lr", "1e-5",
         "--outer_lr", "1e-5", "--number_of_training_steps_per_iter", "1",
         "--number_of_evaluation_steps_per_iter", "1", "--max_epoch", "1",
         "--total_iter_per_epoch", "2", "--num_workers", "1", "--device",
         "cpu"]
RUNS = {"mesh": ["--mesh_shape", "2"],
        "idle": ["--episode_parallel", "false"]}
TIMEOUT = 240
RTOL = 1e-5


def _torchrun(out: pathlib.Path, extra):
    """Start 2 ranks of the CLI under torchrun, each rank's output in a
    file of its own under ``out/logs``."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "--log-dir", str(out / "logs"),
           "--redirects", "3", "-m", "meta_interpolation_tpu_torch.main",
           *FLAGS, *extra, "--checkpoint_dir", str(out / "ck")]
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _rank_log(out: pathlib.Path, rank: int) -> str:
    (path,) = (out / "logs").glob(f"*/attempt_0/{rank}/stdout.log")
    return path.read_text()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both torchrun runs, started together, and the one-process run
    meanwhile; every group is waited for with a time limit. Their
    checkpoints are removed after the file's tests."""
    base = tmp_path_factory.mktemp("torchrun")
    procs = {name: _torchrun(base / name, extra)
             for name, extra in RUNS.items()}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        main(FLAGS + ["--checkpoint_dir", str(base / "one")])
    finally:
        torch.set_num_threads(threads)
        for name, proc in procs.items():
            try:
                out, _ = proc.communicate(timeout=TIMEOUT)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, _ = proc.communicate()
                pytest.fail(f"torchrun {name} outlasted {TIMEOUT} s:\n{out}")
            assert proc.returncode == 0, out
    yield base
    shutil.rmtree(base, ignore_errors=True)


def _meta(path: pathlib.Path):
    return torch.load(path / "exp" / "checkpoint.pth",
                      weights_only=False)


def test_torchrun_trains_as_one_process(runs):
    out = runs / "mesh"
    logs = [_rank_log(out, r) for r in range(2)]
    assert "backend gloo on cpu" in logs[0] and "backend gloo" in logs[1]
    assert "mesh: Mesh(task=2, spatial=1, ranks=[0, 1])" in logs[0]
    for marker in ("[epoch 0 it 0]", "[val epoch 0]"):
        assert marker in logs[0] and marker not in logs[1]
    got, want = _meta(out / "ck"), _meta(runs / "one")
    assert got["epoch"] == want["epoch"] == 1
    assert got["best_PSNR"] == pytest.approx(want["best_PSNR"], abs=1e-4)
    assert got["arch"]["mesh_shape"] == "2"
    g_net = got["system"]["meta_params"]["net"]
    for k, v in want["system"]["meta_params"]["net"].items():
        err = float((g_net[k] - v).norm())
        assert err <= RTOL * float(v.norm()), (k, err)
    g_lrs, w_lrs = (m["system"]["meta_params"]["lrs"] for m in (got, want))
    diff = sum(float((g_lrs[k] - v).double().norm()) ** 2
               for k, v in w_lrs.items()) ** 0.5
    ref = sum(float(v.double().norm()) ** 2 for v in w_lrs.values()) ** 0.5
    assert diff <= RTOL * ref


def test_episode_parallel_false_runs_rank_0_alone(runs):
    out = runs / "idle"
    logs = [_rank_log(out, r) for r in range(2)]
    assert "outside the mesh, idle" in logs[1]
    assert "[epoch 0 it 0]" in logs[0] and "[epoch" not in logs[1]
    got, want = _meta(out / "ck"), _meta(runs / "one")
    for group, tree in want["system"]["meta_params"].items():
        for k, v in tree.items():
            assert torch.equal(got["system"]["meta_params"][group][k], v), k
