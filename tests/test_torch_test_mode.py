"""The port's ×2 slow-motion test mode (``--mode test``) held against the
JAX package's on the CPU: ``run_test_iter`` for SepConv (through the plain
K1/K2 here), and the CLI on a directory of frames and on the synthetic
clips, whose written frames must carry JAX's names, ×2 and then ×4 on the
output, with pixels within one 8-bit level. CAIN's ``run_test_iter`` is
held in tests/test_torch_cain_episode.py.

Tolerances: SepConv's prediction to 1e-4, and, since its random-init
predictions are small (~1e-3), to 1e-3 of their range too (as
tests/test_torch_episode.py holds them).
"""
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from meta_interpolation_tpu.config import Config as JaxConfig
from meta_interpolation_tpu.main import main as jax_main
from meta_interpolation_tpu.meta.system import (
    SceneAdaptiveInterpolation as JaxSystem)
from meta_interpolation_tpu_torch.config import Config
from meta_interpolation_tpu_torch.core import checkpoint as bridge
from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
from meta_interpolation_tpu_torch.main import main
from meta_interpolation_tpu_torch.meta.system import (
    SceneAdaptiveInterpolation)
from meta_interpolation_tpu_torch.ops import sepconv as sc

PRED_ATOL = 1e-4
PRED_OF_RANGE = 1e-3
CROP = 32

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_sepconv_run_test_iter_matches_jax():
    """run_test.sh's flags with SepConv's Adamax and Meta-SGD: adapt on the
    support (0, 1, 2) and (1, 2, 3) of 4 consecutive frames, then the
    midpoint of frames 1 and 2. The JAX step is jitted (op by op it takes
    three times as long on the CPU)."""
    cfg = dict(model="sepconv", optimizer="Adamax", metasgd=True,
               inner_lr=1e-5, number_of_evaluation_steps_per_iter=1,
               mode="test", crop_size=CROP)
    jsys = JaxSystem(JaxConfig(**cfg))
    tsys = SceneAdaptiveInterpolation(Config(**cfg, device="cpu"))
    tsys.load_net(bridge.params_from_jax(
        jax.tree.map(np.asarray, jsys.meta_params["net"]), tsys.model))
    frames = np.asarray(SyntheticSeptuplet(
        model="sepconv", mode="test", size=(CROP, CROP))[0][0])[None, 1:5]
    want = np.asarray(jsys.run_test_iter(frames))
    sc.reset_launches()
    got = tsys.run_test_iter(frames).numpy().transpose(0, 2, 3, 1)
    assert got.shape == (1, CROP, CROP, 3)
    np.testing.assert_allclose(got, want, atol=PRED_ATOL)
    assert np.abs(got - want).max() <= PRED_OF_RANGE * np.abs(want).max()
    # the CPU runs the plain versions, never a kernel
    assert sc.sepconv_forward.launches == sc.sepconv_grad_kernels.launches == 0


TINY_CAIN = ["--model", "cain", "--depth", "2", "--n_resblocks", "1"]


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    """A tiny CAIN's JAX init as a reference-named .pth, which both CLIs
    load (--pretrained_model), so they start from the same weights."""
    from meta_interpolation_tpu.models import cain as jax_cain
    from meta_interpolation_tpu_torch.models.cain import CAIN
    params = jax.tree.map(np.asarray, jax_cain.init(jax.random.PRNGKey(4),
                                                    depth=2, n_resblocks=1))
    path = tmp_path_factory.mktemp("weights") / "cain.pth"
    torch.save(bridge.params_from_jax(params, CAIN(depth=2, n_resblocks=1)),
               path)
    yield path
    path.unlink()


def _frames(root, n=6, hw=(24, 40)):
    rs = np.random.RandomState(9)
    os.makedirs(root)
    base = rs.rand(*hw, 3)
    for i in range(n):
        # a pattern drifting a pixel a frame, so neighbours differ
        img = np.roll(base, i, axis=1) * 0.8 + 0.1 * rs.rand(*hw, 3)
        Image.fromarray((img * 255).astype(np.uint8)).save(
            os.path.join(root, f"frame{i:03d}.png"))
    return root


def _cli(run, root, ckpt, pth, dataset="test"):
    """run_test.sh's flags on the tiny CAIN from ``pth``, through ``run``
    (the port's main on the CPU, or JAX's)."""
    argv = TINY_CAIN + [
        "--pretrained_model", str(pth), "--mode", "test", "--dataset",
        dataset, "--data_root", str(root), "--img_fmt", "png",
        "--number_of_evaluation_steps_per_iter", "1", "--crop_size",
        str(CROP), "--checkpoint_dir", str(ckpt), "--episode_parallel",
        "false"]
    return run(argv + (["--device", "cpu"] if run is main else []))


def _written(root):
    return {name: np.asarray(Image.open(os.path.join(root, name)),
                             np.int16)
            for name in sorted(os.listdir(root))}


def _same_frames(got, want):
    assert sorted(got) == sorted(want)
    for name in want:
        assert np.abs(got[name] - want[name]).max() <= 1, name


def test_cli_writes_the_frames_jax_writes(tmp_path, pth, capsys):
    """run_test.sh on a tiny CAIN over 6 frames, in each package's own
    copy: the inputs renamed to name_0.000000.png, then x2 writes the
    3 midpoints at .500000; run again on that output, x4 writes the 6 at
    .250000 and .750000. Each file of the port's within one 8-bit level of
    JAX's, and no frame overwritten. Both start from one JAX init."""
    port = _frames(str(tmp_path / "port"))
    ref = _frames(str(tmp_path / "jax"))
    before = set(os.listdir(port))
    names = []
    for run in ("x2", "x4"):
        want_count = _cli(jax_main, ref, tmp_path / "jax_ckpt", pth)
        count = _cli(main, port, tmp_path / "port_ckpt", pth)
        got, want = _written(port), _written(ref)
        _same_frames(got, want)
        new = sorted(set(got) - {f"{n[:-4]}_0.000000.png" for n in before}
                     - set(names))
        assert count == want_count == len(new)
        names += new
    assert names == ["frame001_0.500000.png", "frame002_0.500000.png",
                     "frame003_0.500000.png", "frame001_0.250000.png",
                     "frame001_0.750000.png", "frame002_0.250000.png",
                     "frame002_0.750000.png", "frame003_0.250000.png",
                     "frame003_0.750000.png"]
    assert capsys.readouterr().out.count("[test] wrote 6 interpolated") == 2


def test_cli_routes_pseudo_paths_into_the_experiment(tmp_path, pth):
    """The synthetic clips have no directory: their frames go under
    <checkpoint_dir>/<exp_name>/test_output, named as JAX names them."""
    want_count = _cli(jax_main, "unused", tmp_path / "jax", pth,
                      "synthetic")
    count = _cli(main, "unused", tmp_path / "port", pth, "synthetic")
    got = _written(tmp_path / "port" / "exp" / "test_output")
    want = _written(tmp_path / "jax" / "exp" / "test_output")
    assert count == want_count == len(got) == 8
    assert sorted(got)[0] == "0_1_0.500000.png"
    _same_frames(got, want)


def test_viz_writes_the_validation_predictions(tmp_path):
    """--viz in --mode val: each clip's stitched prediction under
    <checkpoint_dir>/<exp_name>/<dataset>, named after its target path
    (the writer itself is held to JAX's in test_torch_datasets.py)."""
    stats = main(TINY_CAIN + ["--mode", "val", "--dataset", "synthetic",
                              "--crop_size", str(CROP), "--viz",
                              "--checkpoint_dir", str(tmp_path),
                              "--device", "cpu"])
    assert np.isfinite(stats["psnr"])
    out = tmp_path / "exp" / "synthetic"
    assert sorted(os.listdir(out)) == [f"synthetic__{i}_3.png"
                                       for i in range(8)]
    assert np.asarray(Image.open(out / "synthetic__0_3.png")).shape == (
        CROP, CROP, 3)
