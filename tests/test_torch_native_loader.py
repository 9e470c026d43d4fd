"""The port's C++ preprocessing (data/native) and threaded TaskLoader held
against the JAX package's on the CPU: ``prep_batch`` bit for bit against
JAX's build of the same source, and batches of a small Vimeo-layout PNG
fixture bit for bit against the JAX loader's, on the native path and on
the numpy path."""
import types

import numpy as np
import pytest
from PIL import Image

from meta_interpolation_tpu.data import loader as jax_loader
from meta_interpolation_tpu.data import native as jax_native
from meta_interpolation_tpu_torch.data import loader, native
from meta_interpolation_tpu_torch.data.datasets import VimeoSeptuplet

CONSTANTS = {  # (mean, std, inv255) per model, as norm_constants gives them
    "sepconv": (np.zeros(3, np.float32), np.ones(3, np.float32), 1 / 255),
    "superslomo": (np.asarray([0.429, 0.431, 0.397], np.float32),
                   np.ones(3, np.float32), 1 / 255),
    "voxelflow": (np.full(3, 127.5, np.float32), np.full(3, 127.5,
                                                         np.float32), 1.0)}


@pytest.mark.parametrize("model", CONSTANTS)
def test_prep_batch_matches_jax_native_bitwise(model):
    rs = np.random.RandomState(0)
    frames = rs.randint(0, 256, (3, 7, 20, 24, 3), dtype=np.uint8)
    args = (frames, 16, 12, np.asarray([0, 2, 4]), np.asarray([1, 0, 12]),
            np.asarray([0, 1, 0]), *CONSTANTS[model])
    got = native.prep_batch(*args, num_threads=2)
    want = jax_native.prep_batch(*args, num_threads=3)
    assert native.FALLBACK is None and got is not None and want is not None
    assert got.shape == (3, 7, 16, 12, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # the numpy transcription: (u8·inv255 − mean)/std. Not bitwise: the C++
    # may fuse the product and the difference (one rounding, -march=native
    # with FMA), so within one float32 ulp of the largest product, over std
    mean, std, inv255 = CONSTANTS[model]
    atol = float(np.spacing(np.float32(255 * inv255)) / std.min())
    for i, (oy, ox, flip) in enumerate(zip(*args[3:6])):
        clip = frames[i, ::-1] if flip else frames[i]
        crop = clip[:, oy:oy + 16, ox:ox + 12].astype(np.float32)
        ref = (crop * np.float32(inv255) - mean) / std
        np.testing.assert_allclose(got[i], ref, rtol=0, atol=atol)


def test_build_failure_falls_back_loudly_once(monkeypatch, capsys):
    def broken():
        raise OSError("g++: not found")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "FALLBACK", None)
    monkeypatch.setattr(native, "build", broken)
    assert native.load() is None and native.load() is None
    assert "g++: not found" in native.FALLBACK
    err = capsys.readouterr().err
    assert err.count("WARNING") == 1 and "numpy path" in err
    assert native.prep_batch(np.zeros((1, 1, 2, 2, 3), np.uint8), 2, 2,
                             [0], [0], [0], *CONSTANTS["sepconv"]) is None


@pytest.fixture(scope="module")
def vimeo(tmp_path_factory):
    """Five septuplets of 20x28 frames in the Vimeo90K layout."""
    root = tmp_path_factory.mktemp("vimeo")
    rs = np.random.RandomState(1)
    seqs = [f"0000{i}/0001" for i in range(5)]
    for seq in seqs:
        d = root / "sequences" / seq
        d.mkdir(parents=True)
        for t in range(1, 8):
            Image.fromarray(rs.randint(0, 256, (20, 28, 3), dtype=np.uint8)
                            ).save(d / f"im{t}.png")
    (root / "sep_trainlist.txt").write_text("\n".join(seqs))
    (root / "sep_testlist.txt").write_text("\n".join(seqs[:2]))
    return str(root)


def _cfg(root, model, workers):
    return types.SimpleNamespace(
        dataset="vimeo90k", data_root=root, model=model, mode="train",
        crop_size=16, test_mode="hard", img_fmt="png", batch_size=2,
        val_batch_size=2, test_batch_size=2, num_workers=workers,
        random_seed=3)


def _batches(mod, root, model, workers, split="train"):
    data = mod.MetaLearningSystemDataLoader(_cfg(root, model, workers))
    gen = (data.get_train_batches(epoch=1) if split == "train"
           else data.get_val_batches())
    return list(gen)


@pytest.mark.parametrize("path", ["native", "numpy"])
@pytest.mark.parametrize("model", ["sepconv", "superslomo"])
def test_loader_batches_match_jax(vimeo, model, path, monkeypatch):
    """Train batches (random crops and flips from the seeded stream, drawn
    in batch order) and val batches, bit for bit the JAX loader's, at 1
    and 3 workers; on the numpy path both loaders have their C++ library
    taken away."""
    if path == "numpy":
        monkeypatch.setattr(native, "load", lambda: None)
        monkeypatch.setattr(jax_native, "load", lambda: None)
    for split in ("train", "val"):
        want = _batches(jax_loader, vimeo, model, 3, split)
        for workers in (1, 3):
            got = _batches(loader, vimeo, model, workers, split)
            assert len(got) == len(want) == (3 if split == "train" else 1)
            for (g, gm), (w, wm) in zip(got, want):
                assert g.shape == w.shape
                np.testing.assert_array_equal(g, w)
                assert gm == wm
    flipped = [m["imgpaths"][0].endswith("im7.png")
               for _, meta in _batches(loader, vimeo, model, 2)
               for m in meta]
    assert any(flipped) and not all(flipped)


def test_native_and_numpy_paths_agree(vimeo, monkeypatch):
    """The same raw frames and augmentation draws on both paths: within
    one float32 ulp (x·(1/255) against x/255)."""
    native_batches = _batches(loader, vimeo, "sepconv", 2)
    monkeypatch.setattr(native, "load", lambda: None)
    numpy_batches = _batches(loader, vimeo, "sepconv", 2)
    for (a, am), (b, bm) in zip(native_batches, numpy_batches):
        np.testing.assert_array_max_ulp(a, b, maxulp=1)
        assert am == bm


def test_normalisation_check_refuses_a_model_it_cannot_express(vimeo):
    ds = VimeoSeptuplet(vimeo, model="sepconv")
    assert loader.TaskLoader(ds, 2)._native_norm_ok()
    ds.norm_constants = lambda: (np.full(3, 0.5, np.float32),
                                 np.ones(3, np.float32), 1 / 255)
    with pytest.warns(UserWarning, match="python data path"):
        assert not loader.TaskLoader(ds, 2)._native_norm_ok()
