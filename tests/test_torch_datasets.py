"""The port's dataset readers, loader and image writers held against the
JAX package's on tiny image trees written to a temporary directory, laid
out as each reference reader expects: the same clips (arrays equal: both
decode the same PNGs and normalize with the same arithmetic) and the same
``imgpaths``, and the same files written, pixel for pixel."""
import os

import numpy as np
import pytest
import torch
from PIL import Image

from meta_interpolation_tpu.config import Config as JaxConfig
from meta_interpolation_tpu.data import datasets as jax_ds
from meta_interpolation_tpu.data.loader import (
    MetaLearningSystemDataLoader as JaxLoader)
from meta_interpolation_tpu.utils import viz as jax_viz
from meta_interpolation_tpu_torch.config import Config
from meta_interpolation_tpu_torch.data import datasets
from meta_interpolation_tpu_torch.data.loader import (
    MetaLearningSystemDataLoader)
from meta_interpolation_tpu_torch.utils import viz

HW = (8, 12)


def _png(path, seed, hw=HW):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    rs = np.random.RandomState(seed)
    Image.fromarray(rs.randint(0, 256, hw + (3,), np.uint8)).save(path)


def _same(got_ds, want_ds):
    """Every clip of both readers equal, paths included."""
    assert len(got_ds) == len(want_ds) > 0
    for i in range(len(want_ds)):
        (g, g_meta), (w, w_meta) = got_ds[i], want_ds[i]
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)
        assert g_meta == w_meta


def _middlebury(root):
    for s, (d, n) in enumerate((("Beanbags", 8), ("Dimetrodon", 8),
                                ("Short", 5))):
        for i in range(n):
            _png(str(root / "other-data-all" / d / f"frame{i + 7:02d}.png"),
                 seed=10 * s + i)
        _png(str(root / "other-gt-interp" / d / "frame10i11.png"), seed=n)
    return root


@pytest.mark.parametrize("model", ["cain", "superslomo", "voxelflow"])
def test_middlebury_matches_jax(tmp_path, model):
    """Directories of 8 frames only; the middle four and the ground truth
    as the pseudo-septuplet [i0, 0, i1, gt, i2, 0, i3]; each model's
    normalization."""
    root = str(_middlebury(tmp_path))
    got = datasets.get_dataset("middlebury", root, model, "val")
    want = jax_ds.get_dataset("middlebury", root, model, "val")
    assert isinstance(got, datasets.Middlebury)
    _same(got, want)
    frames, meta = got[0]
    assert frames.shape == (7,) + HW + (3,) and not frames[1].any()
    assert meta["imgpaths"][1] == meta["imgpaths"][5] == ""
    assert meta["imgpaths"][3].endswith("Beanbags/frame10i11.png")
    assert len(got) == 2


@pytest.mark.parametrize("counts", [(10, 5), (7, 13), (6, 2)], ids=str)
def test_hd_windows_match_jax(tmp_path, counts):
    """Stride-2 windows of 7 with the reference's tail windows (the last 7
    frames once for every step left) and a short directory repeated a
    step at a time."""
    for s, n in enumerate(counts):
        for i in range(n):
            _png(str(tmp_path / f"seq{s}" / f"{i:04d}.png"), seed=s * 50 + i)
    (tmp_path / "notes.txt").write_text("not a sequence")
    got = datasets.get_dataset("hd", str(tmp_path), "cain", "val")
    want = jax_ds.get_dataset("hd", str(tmp_path), "cain", "val")
    _same(got, want)
    assert got.clips == want.clips
    n = counts[0]
    first = got.clips[:(n + 1) // 2]           # the first directory's
    for t, clip in zip(range(0, n, 2), first):
        frames = sorted(os.listdir(tmp_path / "seq0"))
        if n < 7:
            assert [os.path.basename(p) for p in clip] == frames
        else:
            start = t if t + 7 <= n else n - 7
            assert [os.path.basename(p) for p in clip] == frames[start:
                                                                 start + 7]


@pytest.mark.parametrize("test_mode", ["easy", "medium", "hard", "extreme"])
def test_snufilm_honours_test_mode_as_jax(tmp_path, test_mode):
    """Quintuplets from test-{mode}-meta.txt, zero-padded to [a, 0, b, c,
    d, 0, e]; a missing list is an empty set in both."""
    for m, mode in enumerate(("easy", "hard")):
        lines = []
        for q in range(2):
            paths = [str(tmp_path / mode / f"{q}_{i}.png") for i in range(5)]
            for i, p in enumerate(paths):
                _png(p, seed=100 * m + 10 * q + i)
            lines.append(" ".join(paths))
        (tmp_path / f"test-{mode}-meta.txt").write_text(
            "\n".join(lines) + "\n")
    cfg = dict(dataset="snufilm", data_root=str(tmp_path), model="cain",
               mode="val", test_mode=test_mode)
    got = MetaLearningSystemDataLoader(Config(**cfg)).dataset
    want = JaxLoader(JaxConfig(**cfg)).dataset
    assert isinstance(got, datasets.SNUFILM)
    if test_mode in ("easy", "hard"):
        _same(got, want)
        frames, meta = got[1]
        assert not frames[1].any() and not frames[5].any()
        assert meta["imgpaths"][3].endswith(f"{test_mode}/1_2.png")
    else:
        assert len(got) == len(want) == 0


def test_davis_matches_jax_in_both_layouts(tmp_path):
    """JPEGImages/480p/<seq>/*.jpg, and directories of PNGs under the
    root: stride-2 windows of 7."""
    davis = tmp_path / "davis" / "JPEGImages" / "480p"
    for s, n in enumerate((9, 6)):
        for i in range(n):
            path = davis / f"seq{s}" / f"{i:05d}.jpg"
            os.makedirs(path.parent, exist_ok=True)
            rs = np.random.RandomState(s * 10 + i)
            Image.fromarray(rs.randint(0, 256, HW + (3,), np.uint8)).save(
                path, quality=95)
    for i in range(8):
        _png(str(tmp_path / "flat" / "bmx" / f"{i:05d}.png"), seed=70 + i)
    for root in ("davis", "flat"):
        got = datasets.get_dataset("davis", str(tmp_path / root), "voxelflow",
                                   "val")
        want = jax_ds.get_dataset("davis", str(tmp_path / root), "voxelflow",
                                  "val")
        _same(got, want)
    assert len(got) == 1


def _frame_dir(root, names):
    for i, name in enumerate(names):
        _png(str(root / name), seed=200 + i)
    return root


@pytest.mark.parametrize("names", [
    ["a.png", "b.png", "c.png", "d.png", "e.png"],
    ["x.png", "y.png"],
    ["clip_0.000000.png", "clip_0.500000.png", "clip_1.000000.png",
     "other.png", "z_1.000000.png"]], ids=["fresh", "short", "renamed"])
def test_video_dataset_renames_and_windows_as_jax(tmp_path, names):
    """Frames not yet named name_%.06f.ext are renamed on disk to
    name_0.000000.ext (both packages rename their own copy the same way);
    windows of 4 slide by one; a directory of 1-3 frames is one window with
    its last frame repeated."""
    got_root = _frame_dir(tmp_path / "port", names)
    want_root = _frame_dir(tmp_path / "jax", names)
    cfg = dict(dataset="test", model="cain", mode="test", img_fmt="png")
    got_loader = MetaLearningSystemDataLoader(
        Config(**cfg, data_root=str(got_root)))
    want_loader = JaxLoader(JaxConfig(**cfg, data_root=str(want_root)))
    assert isinstance(got_loader.dataset, datasets.VideoDataset)
    assert sorted(os.listdir(got_root)) == sorted(os.listdir(want_root))
    assert all(n.count("_") >= 1 and n.split("_")[-1][:-4].replace(
        ".", "").isdigit() for n in os.listdir(got_root))
    got = list(got_loader.get_test_batches())
    want = list(want_loader.get_test_batches())
    assert len(got) == len(want) == max(1, len(names) - 3)
    for (g, g_meta), (w, w_meta) in zip(got, want):
        assert g.shape == (1, 4) + HW + (3,)
        np.testing.assert_array_equal(g, w)
        rel = lambda meta, root: [os.path.relpath(p, root)
                                  for p in meta[0]["imgpaths"]]
        assert rel(g_meta, got_root) == rel(w_meta, want_root)
    if names == ["x.png", "y.png"]:
        assert got[0][1][0]["imgpaths"][2:] == [
            str(got_root / "y_0.000000.png")] * 2


@pytest.mark.parametrize("name", ["middlebury", "hd", "snufilm", "davis",
                                  "test"])
def test_get_dataset_serves_every_reader_as_jax(tmp_path, name):
    got = datasets.get_dataset(name, str(tmp_path), "sepconv", "val")
    want = jax_ds.get_dataset(name, str(tmp_path), "sepconv", "val")
    assert type(got).__name__ == type(want).__name__
    with pytest.raises(NotImplementedError, match="nosuchset"):
        datasets.get_dataset("nosuchset", str(tmp_path), "sepconv", "val")


def test_normalize_for_model_passes_an_unknown_name_through():
    """As JAX's: the registry's normalization for a model it knows (here
    the default model, CAIN, the identity), the frame unchanged for a name
    it does not."""
    x = np.random.RandomState(1).rand(4, 5, 3).astype(np.float32)
    for model in ("cain", "nosuchmodel", "voxelflow"):
        np.testing.assert_array_equal(
            datasets.normalize_for_model(x, model),
            jax_ds.normalize_for_model(x, model))
    assert datasets.normalize_for_model(x, "nosuchmodel") is x


def test_save_batch_images_matches_jax(tmp_path):
    """The names (the target path with '/' → '_' and ':' dropped, or
    pred_b) and the 8-bit pixels, from predictions past [0, 1] too."""
    rs = np.random.RandomState(2)
    preds = (rs.rand(3, 6, 9, 3).astype(np.float32) * 1.4 - 0.2)
    meta = [{"imgpaths": ["a", "", "b", "synthetic://0/3", "c", "", "d"]},
            {"imgpaths": ["a", "", "b", "/data/seq/im4.png", "c", "", "d"]},
            {"imgpaths": ["a", "", "b", "", "c", "", "d"]}]
    got = viz.save_batch_images(
        torch.from_numpy(preds.transpose(0, 3, 1, 2).copy()), meta,
        str(tmp_path / "port"))
    want = jax_viz.save_batch_images(preds, meta, str(tmp_path / "jax"))
    rel = lambda paths, root: [os.path.relpath(p, tmp_path / root)
                               for p in paths]
    assert rel(got, "port") == rel(want, "jax") == [
        "synthetic__0_3.png", "_data_seq_im4.png.png", "pred_2.png"]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(Image.open(g)),
                                      np.asarray(Image.open(w)))


def test_make_video_without_frames_or_ffmpeg_returns_none(tmp_path):
    out = str(tmp_path / "v.mp4")
    assert viz.make_video(str(tmp_path), out) is None
    assert jax_viz.make_video(str(tmp_path), out) is None
