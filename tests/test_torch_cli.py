"""The port's command-line surface against the JAX package's, on the CPU: the CLI
(meta_interpolation_tpu_torch.main) loading the same reference-named
``.pth`` and returning the same PSNR, the flag surface, the data pipeline
and the evaluation tiling."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from meta_interpolation_tpu.config import Config as JaxConfig
from meta_interpolation_tpu.config import get_args as jax_get_args
from meta_interpolation_tpu.core.experiment import (
    ExperimentBuilder as JaxExperimentBuilder)
from meta_interpolation_tpu.data.loader import (
    MetaLearningSystemDataLoader as JaxLoader)
from meta_interpolation_tpu.main import main as jax_main
from meta_interpolation_tpu.models import sepconv as jax_sepconv
from meta_interpolation_tpu_torch.config import Config, get_args
from meta_interpolation_tpu_torch.core import checkpoint as bridge
from meta_interpolation_tpu_torch.core.experiment import ExperimentBuilder
from meta_interpolation_tpu_torch.data.datasets import get_dataset
from meta_interpolation_tpu_torch.data.loader import (
    MetaLearningSystemDataLoader)
from meta_interpolation_tpu_torch.main import main
from meta_interpolation_tpu_torch.models.sepconv import SepConv

PSNR_TOL_DB = 0.01

pytestmark = pytest.mark.usefixtures("two_threads")


@pytest.fixture(scope="module")
def two_threads():
    """Two intra-op threads for this file's PyTorch work: the tier-1 run
    puts six test processes on the machine's cores, where every process
    taking a thread a core oversubscribes them many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _argv(pth, ckpt_dir):
    return ["--model", "sepconv", "--mode", "val", "--dataset", "synthetic",
            "--crop_size", "64", "--pretrained_model", str(pth),
            "--optimizer", "Adamax", "--metasgd", "--inner_lr", "1e-5",
            "--number_of_evaluation_steps_per_iter", "1",
            "--val_batch_size", "1", "--loss", "1*L1",
            "--checkpoint_dir", str(ckpt_dir), "--episode_parallel", "false"]


def test_cli_val_matches_jax_cli(tmp_path, capsys):
    params = jax.tree.map(np.asarray, jax_sepconv.init(jax.random.PRNGKey(7)))
    pth = tmp_path / "sepconv.pth"
    torch.save(bridge.params_from_jax(params, SepConv()), pth)

    want = jax_main(_argv(pth, tmp_path / "jax"))
    got = main(_argv(pth, tmp_path / "torch") + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("[val epoch 0] loss") == 2
    assert "[checkpoint] loaded 94/94 tensors" in out
    assert np.isfinite(got["psnr"]) and np.isfinite(got["ssim"])
    assert abs(got["psnr"] - want["psnr"]) <= PSNR_TOL_DB, (got, want)
    assert abs(got["ssim"] - want["ssim"]) <= 1e-4, (got, want)
    for path in tmp_path.rglob("*.pth"):   # weights read: free the disk
        path.unlink()


def test_flag_surface_matches_jax_plus_device():
    argv = ["--model", "sepconv", "--metasgd", "--inner_lr", "3e-4",
            "--number_of_evaluation_steps_per_iter", "3", "--loss",
            "1*L1+0.5*MSE", "--jit_episode", "false", "--crop_size", "96"]
    want = dataclasses.asdict(jax_get_args(argv))
    got = dataclasses.asdict(get_args(argv + ["--device", "cpu"]))
    assert got.pop("device") == "cpu"
    assert got == want
    assert Config().device == "cuda"
    assert Config().support_idxs("train") == JaxConfig().support_idxs("train")
    assert Config().target_idxs == JaxConfig().target_idxs
    with pytest.raises(SystemExit):
        get_args(["--device", "tpu"])


@pytest.mark.parametrize("dataset", ["synthetic", "vimeo90k"])
def test_val_batches_match_jax(dataset, tmp_path):
    """The same clips in the same order; a missing Vimeo90K root falls
    back to the synthetic clips in both packages."""
    kw = dict(model="sepconv", mode="val", dataset=dataset, crop_size=32,
              data_root=str(tmp_path / "absent"), val_batch_size=3)
    got = list(MetaLearningSystemDataLoader(Config(**kw)).get_val_batches())
    want = list(JaxLoader(JaxConfig(**kw)).get_val_batches())
    assert len(got) == len(want) == 3           # 8 clips in batches of 3
    for (g, g_meta), (w, w_meta) in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g_meta == w_meta
    assert got[0][0].shape == (3, 7, 32, 32, 3)
    # every reader of the JAX package is served; a name neither knows is
    # refused
    assert type(get_dataset("middlebury", str(tmp_path), "sepconv",
                            "val")).__name__ == "Middlebury"
    with pytest.raises(NotImplementedError, match="nosuchset"):
        get_dataset("nosuchset", str(tmp_path), "sepconv", "val")


class _EchoSystem:
    """Stands in for the system: the prediction is the clip's target frame,
    the loss its mean, so stitching and averaging are visible."""

    def __init__(self, nchw):
        self.nchw = nchw

    def run_validation_iter(self, frames):
        target = frames[:, 3]
        losses = {"loss": float(target.mean()), "psnr": 0.0, "ssim": 0.0}
        if self.nchw:
            return losses, torch.from_numpy(
                np.ascontiguousarray(target.transpose(0, 3, 1, 2)))
        return losses, target


def test_tiled_val_iter_matches_jax():
    """12×20 frames under a 60-pixel limit split W, then H: four 6×10
    tiles, stitched back in place (NCHW here, NHWC in JAX)."""
    frames = np.random.RandomState(0).rand(2, 7, 12, 20, 3).astype(
        np.float32)
    jax_builder = JaxExperimentBuilder(JaxConfig(), None, _EchoSystem(False))
    builder = ExperimentBuilder(Config(), None, _EchoSystem(True))
    j_losses, j_preds = jax_builder._tiled_val_iter(frames, 60)
    losses, preds = builder._tiled_val_iter(frames, 60)
    np.testing.assert_array_equal(preds.numpy().transpose(0, 2, 3, 1),
                                  j_preds)
    np.testing.assert_array_equal(j_preds, frames[:, 3])
    assert losses == j_losses


def _vimeo_tree(root, seqs=("00001/0001", "00002/0007"), hw=(40, 48)):
    """A Vimeo90K-shaped tree: septuplets of 7 PNGs, train and test
    lists."""
    from PIL import Image
    rs = np.random.RandomState(5)
    for seq in seqs:
        d = root / "sequences" / seq
        d.mkdir(parents=True)
        for i in range(1, 8):
            Image.fromarray(rs.randint(0, 256, hw + (3,), np.uint8)).save(
                d / f"im{i}.png")
    (root / "sep_trainlist.txt").write_text("\n".join(seqs) + "\n")
    (root / "sep_testlist.txt").write_text(seqs[0] + "\n")
    return root


@pytest.mark.parametrize("dataset", ["synthetic", "vimeo90k absent",
                                     "vimeo90k"])
def test_train_batches_match_jax(dataset, tmp_path):
    """The same training clips in the same order over two epochs: the
    shuffle, and on a Vimeo90K tree the crop offsets and temporal flips
    drawn from the seeded stream (40×48 frames cropped to 32)."""
    root = (_vimeo_tree(tmp_path / "vimeo") if dataset == "vimeo90k"
            else tmp_path / "absent")
    kw = dict(model="sepconv", mode="train", dataset=dataset.split()[0],
              crop_size=32, data_root=str(root), batch_size=1)
    got_loader = MetaLearningSystemDataLoader(Config(**kw))
    want_loader = JaxLoader(JaxConfig(**kw))
    for epoch in (0, 1):
        got = list(got_loader.get_train_batches(3, epoch=epoch))
        want = list(want_loader.get_train_batches(3, epoch=epoch))
        assert len(got) == len(want) == (2 if dataset == "vimeo90k" else 3)
        for (g, g_meta), (w, w_meta) in zip(got, want):
            assert g.shape == w.shape == (1, 7, 32, 32, 3)
            # the JAX package's native path scales by 1/255 where numpy
            # divides: the same 8-bit values up to one rounding
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-7)
            assert g_meta == w_meta
    if dataset == "vimeo90k":
        # the stream's draws show: flipped and unflipped clips, and more
        # than one crop offset
        from PIL import Image

        from meta_interpolation_tpu_torch.data import native
        from meta_interpolation_tpu_torch.data.datasets import load_image

        def full_frame(path):
            # the frame as the loader's path computes it: the C++ prep
            # scales the 8-bit values by 1/255 where numpy divides by 255
            if native.load() is None:
                return load_image(path)
            with Image.open(path) as im:
                u8 = np.asarray(im.convert("RGB"), np.uint8)
            return u8.astype(np.float32) * np.float32(1.0 / 255.0)

        offsets, flips = set(), set()
        for e in (0, 1):
            for frames, meta in got_loader.get_train_batches(-1, epoch=e):
                paths = meta[0]["imgpaths"]
                flips.add(paths[0].endswith("im7.png"))
                full = full_frame(paths[0])
                offsets |= {(y, x) for y in range(9) for x in range(17)
                            if np.array_equal(full[y:y + 32, x:x + 32],
                                              frames[0, 0])}
        assert flips == {True, False} and len(offsets) > 1, (flips, offsets)
