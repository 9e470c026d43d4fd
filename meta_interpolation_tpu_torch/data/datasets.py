"""Datasets: numpy (T, H, W, C) float32 clips in model input space.

The port's own copy of ``meta_interpolation_tpu/data/datasets.py``:
Vimeo90K septuplets (reference data/vimeo_septuplet.py:10-89), the
Middlebury, HD, SNU-FILM and DAVIS evaluation sets, the frame directory
of ``--mode test`` (:class:`VideoDataset`), the procedural
:class:`SyntheticSeptuplet`, and the :func:`get_dataset` dispatch with its
fallback to synthetic data when Vimeo90K is missing. Each dataset exposes
``switch_set(name)``, ``__len__`` and ``__getitem__(i) -> (frames,
{'imgpaths': [...]})``; Vimeo90K also serves uint8 frames and its
augmentation draws to the loader's C++ path (``data/native``).
"""
from __future__ import annotations

import glob
import os
import random
from typing import Dict, List, Optional, Tuple

import numpy as np

try:
    from PIL import Image
except ImportError:  # pragma: no cover
    Image = None


def normalize_for_model(img01: np.ndarray, model: str) -> np.ndarray:
    """[0,1] HWC float32 → model input space, via the registry's
    ``ModelDef.normalize``. A name the registry does not know passes
    through unchanged."""
    from ..models import registry
    try:
        return np.asarray(registry.get(model).normalize(img01), np.float32)
    except NotImplementedError:
        return img01


def load_image(path: str) -> np.ndarray:
    """Decode to HWC RGB float32 in [0,1]."""
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.float32) / 255.0


class _Base:
    current_set_name: str = "train"
    data_length: Dict[str, int]

    def switch_set(self, set_name: str, current_iter=None):
        self.current_set_name = set_name

    def __len__(self):
        return self.data_length[self.current_set_name]


class VimeoSeptuplet(_Base):
    """Vimeo90K septuplets. Train: random crop_size crop + random temporal
    flip from one seeded stream; val: whole frames."""

    def __init__(self, data_root: str, model: str = "sepconv",
                 mode: str = "train", crop_size: int = 256,
                 rng: Optional[random.Random] = None):
        self.image_root = os.path.join(data_root, "sequences")
        self.model = model
        self.crop_size = crop_size
        self.rng = rng or random.Random(12345)
        with open(os.path.join(data_root, "sep_trainlist.txt")) as f:
            self.trainlist = f.read().splitlines()
        with open(os.path.join(data_root, "sep_testlist.txt")) as f:
            self.testlist = f.read().splitlines()
        self.current_set_name = "train" if mode == "train" else "val"
        self.data_length = {"train": len(self.trainlist),
                            "val": len(self.testlist), "test": 0}

    def _paths(self, index):
        lst = (self.trainlist if self.current_set_name == "train"
               else self.testlist)
        seq = lst[index % len(lst)]
        return [os.path.join(self.image_root, seq, f"im{i}.png")
                for i in range(1, 8)]

    def frame_hw(self):
        """(H, W) of the dataset's frames, from the first one's header."""
        if getattr(self, "_hw", None) is None:
            with Image.open(self._paths(0)[0]) as im:
                self._hw = (im.height, im.width)
        return self._hw

    def getitem_with_aug(self, index, aug):
        """One clip with augmentation drawn outside (:meth:`aug_params`), so
        the loader draws the seeded stream serially while the decodes run
        in its pool."""
        oy, ox, flip, ch, cw = aug
        paths = self._paths(index)
        images = [load_image(p) for p in paths]
        if self.current_set_name == "train":
            images = [im[oy:oy + ch, ox:ox + cw] for im in images]
            if flip:
                images, paths = images[::-1], paths[::-1]
        frames = np.stack([normalize_for_model(im, self.model)
                           for im in images])
        return frames, {"imgpaths": paths}

    def __getitem__(self, index):
        return self.getitem_with_aug(index, self.aug_params(*self.frame_hw()))

    # the native path (data/native): decode to uint8, then C++ transforms
    def get_raw(self, index):
        """(T, H, W, 3) uint8 frames and the metadata, untransformed."""
        paths = self._paths(index)
        frames = []
        for p in paths:
            with Image.open(p) as im:
                frames.append(np.asarray(im.convert("RGB"), np.uint8))
        return np.stack(frames), {"imgpaths": paths}

    def aug_params(self, h: int, w: int):
        """A clip's (crop y, crop x, temporal flip, crop h, crop w) from the
        one seeded stream both paths draw; the crop is clamped to the
        frame."""
        if self.current_set_name != "train":
            return 0, 0, 0, h, w
        ch, cw = min(self.crop_size, h), min(self.crop_size, w)
        rh = self.rng.randint(0, max(0, h - ch))
        rw = self.rng.randint(0, max(0, w - cw))
        flip = int(self.rng.random() >= 0.5)
        return rh, rw, flip, ch, cw

    def norm_constants(self):
        """(mean, std, inv255) of the C++ normalisation (u8·inv255 −
        mean)/std for this dataset's model."""
        from ..models.registry import SSM_MEAN
        if self.model == "superslomo":
            return SSM_MEAN, np.ones(3, np.float32), 1.0 / 255.0
        if self.model == "voxelflow":
            return (np.full(3, 127.5, np.float32),
                    np.full(3, 127.5, np.float32), 1.0)
        return (np.zeros(3, np.float32), np.ones(3, np.float32), 1.0 / 255.0)


def _load_clip(paths, model: str) -> np.ndarray:
    return np.stack([normalize_for_model(load_image(p), model)
                     for p in paths])


class Middlebury(_Base):
    """Middlebury OTHERS evaluation set (reference data/middlebury.py
    :12-109): of each directory of 8 frames the middle 4 and the
    ground truth ``frame10i11.png``, packed as the pseudo-septuplet [i0, 0,
    i1, gt, i2, 0, i3]."""

    def __init__(self, data_root: str, model: str = "cain"):
        self.model = model
        image_root = os.path.join(data_root, "other-data-all")
        gt_root = os.path.join(data_root, "other-gt-interp")
        self.imglist: List[List[str]] = []
        self.gt_list: List[str] = []
        for d in sorted(glob.glob(image_root + "/*")):
            imgs = sorted(glob.glob(d + "/*.png"))
            if len(imgs) == 8:
                self.imglist.append(imgs[2:6])
                self.gt_list.append(os.path.join(
                    gt_root, os.path.basename(d), "frame10i11.png"))
        self.current_set_name = "val"
        self.data_length = {"train": 0, "val": len(self.imglist), "test": 0}

    def __getitem__(self, index):
        imgs = _load_clip(self.imglist[index], self.model)
        gt = normalize_for_model(load_image(self.gt_list[index]), self.model)
        dummy = np.zeros_like(gt)
        frames = np.stack([imgs[0], dummy, imgs[1], gt, imgs[2], dummy,
                           imgs[3]])
        i0, i1, i2, i3 = self.imglist[index]
        return frames, {"imgpaths": [i0, "", i1, self.gt_list[index], i2,
                                     "", i3]}


class HDDataset(_Base):
    """HD (1080p/720p) sequences as 7-frame windows at stride 2 (reference
    data/hd_dataset.py:11-81). A window that would run past the end is the
    last 7 frames, once for every stride step left (hd_dataset.py:24-34),
    and a directory of fewer than 7 frames is one clip a step."""

    def __init__(self, data_root: str, model: str = "cain"):
        self.model = model
        self.clips: List[List[str]] = []
        for d in sorted(glob.glob(os.path.join(data_root, "*"))):
            if not os.path.isdir(d):
                continue
            imgs = sorted(glob.glob(os.path.join(d, "*.png")))
            for t in range(0, len(imgs), 2):
                if len(imgs) < 7:
                    self.clips.append(imgs)
                else:
                    self.clips.append(imgs[t:t + 7] if t + 7 <= len(imgs)
                                      else imgs[-7:])
        self.current_set_name = "val"
        self.data_length = {"train": 0, "val": len(self.clips), "test": 0}

    def __getitem__(self, index):
        paths = self.clips[index]
        return _load_clip(paths, self.model), {"imgpaths": paths}


class SNUFILM(_Base):
    """SNU-FILM quintuplets from ``test-{test_mode}-meta.txt`` (reference
    data/snufilm.py:8-67), zero-padded to septuplets [a, 0, b, c, d, 0, e]:
    the support (0, 2, 4) is (a, b, d) and the query (b, d) → c. The
    reference reads the hard list whatever ``--test_mode`` says; here, as
    in the JAX package, ``test_mode`` picks the list."""

    def __init__(self, data_root: str, model: str = "cain",
                 test_mode: str = "hard"):
        self.model = model
        list_file = os.path.join(data_root, f"test-{test_mode}-meta.txt")
        self.quintuplets: List[List[str]] = []
        if os.path.exists(list_file):
            with open(list_file) as f:
                for line in f.read().splitlines():
                    parts = line.split(" ")
                    if parts and parts[0]:
                        self.quintuplets.append(parts)
        self.current_set_name = "val"
        self.data_length = {"train": 0, "val": len(self.quintuplets),
                            "test": 0}

    def __getitem__(self, index):
        paths = self.quintuplets[index]
        imgs = _load_clip(paths, self.model)
        zero = np.zeros_like(imgs[0])
        frames = np.stack([imgs[0], zero, imgs[1], imgs[2], imgs[3], zero,
                           imgs[4]])
        return frames, {"imgpaths": [paths[0], "", paths[1], paths[2],
                                     paths[3], "", paths[4]]}


class VideoDataset(_Base):
    """A directory of frames for ×2 slow motion (reference data/video.py
    :9-60), served as sliding windows of 4. Frames not yet named
    ``name_%.06f.ext`` are renamed on disk to ``name_0.000000.ext``, so
    the float indices of the frames that ``--mode test``
    writes sort between them, and a run on the output directory doubles
    the frame rate again. A directory of 1 to 3 frames is one window, its
    last frame repeated."""

    def __init__(self, data_root: str, model: str = "cain",
                 img_fmt: str = "png"):
        self.model = model
        ext = len(img_fmt) + 1
        pattern = os.path.join(data_root, f"*.{img_fmt}")
        for im in sorted(glob.glob(pattern)):
            try:
                float(im.split("_")[-1][:-ext])
            except ValueError:
                os.rename(im, "%s_%.06f.%s" % (im[:-ext], 0.0, img_fmt))
        images = sorted(glob.glob(pattern))
        if images and len(images) < 4:
            self.imglist = [images + [images[-1]] * (4 - len(images))]
        else:
            self.imglist = [images[i:i + 4] for i in range(len(images) - 3)]
        self.current_set_name = "test"
        self.data_length = {"train": 0, "val": 0, "test": len(self.imglist)}

    def __getitem__(self, index):
        paths = self.imglist[index]
        return _load_clip(paths, self.model), {"imgpaths": paths}


class DAVIS(_Base):
    """DAVIS sequences (``JPEGImages/480p/<seq>/*.jpg``, or directories of
    frames directly under the root) as 7-frame windows at stride 2. The
    reference dispatches to a ``data.davis`` module it does not have; this
    is the JAX package's reader."""

    def __init__(self, data_root: str, model: str = "cain"):
        self.model = model
        self.clips: List[List[str]] = []
        seq_root = os.path.join(data_root, "JPEGImages", "480p")
        if not os.path.isdir(seq_root):
            seq_root = data_root
        for d in sorted(glob.glob(os.path.join(seq_root, "*"))):
            if not os.path.isdir(d):
                continue
            imgs = sorted(glob.glob(os.path.join(d, "*.jpg"))
                          or glob.glob(os.path.join(d, "*.png")))
            for s in range(0, len(imgs) - 6, 2):
                self.clips.append(imgs[s:s + 7])
        self.current_set_name = "val"
        self.data_length = {"train": 0, "val": len(self.clips), "test": 0}

    def __getitem__(self, index):
        paths = self.clips[index]
        return _load_clip(paths, self.model), {"imgpaths": paths}


class SyntheticSeptuplet(_Base):
    """Procedural septuplets — deterministic moving scenes with linear
    motion, so frame 4 is exactly the midpoint of 3 and 5. Renders the
    same clips as the JAX package's ``SyntheticSeptuplet`` for the same
    arguments."""

    def __init__(self, model: str = "sepconv", mode: str = "train",
                 size: Tuple[int, int] = (256, 256), length: int = 64,
                 num_frames: int = 7, seed: int = 0, motion: float = 8.0,
                 **_kw):
        self.model = model
        self.size = size
        self.num_frames = num_frames
        self.seed = seed
        self.motion = float(motion)  # |velocity| <= motion/2 px/frame
        self.current_set_name = "train" if mode == "train" else mode
        self.data_length = {"train": length, "val": max(1, length // 8),
                            "test": max(1, length // 8)}
        # rendered clips are deterministic in (set, index): cache them
        self._cache: Dict[Tuple[str, int], Tuple[np.ndarray, list]] = {}

    def _render(self, rng: np.random.RandomState) -> np.ndarray:
        h, w = self.size
        yy, xx = np.meshgrid(np.arange(h, dtype=np.float32),
                             np.arange(w, dtype=np.float32), indexing="ij")
        n_blobs = 6
        cx = rng.rand(n_blobs) * w
        cy = rng.rand(n_blobs) * h
        vx = (rng.rand(n_blobs) - 0.5) * self.motion
        vy = (rng.rand(n_blobs) - 0.5) * self.motion
        radius = 10 + rng.rand(n_blobs) * 30
        color = rng.rand(n_blobs, 3).astype(np.float32)
        bg_phase = rng.rand() * 6.28
        frames = []
        for t in range(self.num_frames):
            img = 0.25 + 0.15 * np.sin(
                xx / 37.0 + yy / 53.0 + bg_phase)[..., None].astype(np.float32)
            img = np.repeat(img, 3, axis=2)
            for b in range(n_blobs):
                d2 = ((xx - (cx[b] + vx[b] * t)) ** 2
                      + (yy - (cy[b] + vy[b] * t)) ** 2)
                mask = np.exp(-d2 / (2 * radius[b] ** 2)).astype(np.float32)
                img = img * (1 - mask[..., None]) + mask[..., None] * color[b]
            frames.append(np.clip(img, 0.0, 1.0))
        return np.stack(frames)

    def __getitem__(self, index):
        key = (self.current_set_name, index)
        hit = self._cache.get(key)
        if hit is not None:
            return hit[0], {"imgpaths": list(hit[1])}
        salt = {"train": 0, "val": 10_000, "test": 20_000}[
            self.current_set_name]
        rng = np.random.RandomState(self.seed + salt + index)
        frames = np.stack([normalize_for_model(f, self.model)
                           for f in self._render(rng)])
        # one cached array is handed to every caller: make it read-only
        frames.setflags(write=False)
        paths = [f"synthetic://{index}/{t}" for t in range(self.num_frames)]
        self._cache[key] = (frames, paths)
        return frames, {"imgpaths": list(paths)}


def get_dataset(name: str, data_root: str, model: str, mode: str,
                crop_size: int = 256, test_mode: str = "hard",
                img_fmt: str = "png"):
    """Dataset dispatch (reference data/__init__.py:535-552). Falls back to
    SyntheticSeptuplet when the Vimeo90K root is missing."""
    name = name.lower()
    if name == "synthetic":
        return SyntheticSeptuplet(model=model, mode=mode,
                                  size=(crop_size, crop_size))
    if name == "vimeo90k":
        if not os.path.exists(os.path.join(data_root, "sep_trainlist.txt")):
            print(f"[data] {data_root} missing — using SyntheticSeptuplet")
            return SyntheticSeptuplet(model=model, mode=mode,
                                      size=(crop_size, crop_size))
        return VimeoSeptuplet(data_root, model=model, mode=mode,
                              crop_size=crop_size)
    if name == "middlebury":
        return Middlebury(data_root, model=model)
    if name == "davis":
        return DAVIS(data_root, model=model)
    if name == "hd":
        return HDDataset(data_root, model=model)
    if name == "snufilm":
        return SNUFILM(data_root, model=model, test_mode=test_mode)
    if name == "test":
        return VideoDataset(data_root, model=model, img_fmt=img_fmt)
    raise NotImplementedError(f"dataset {name!r}")
