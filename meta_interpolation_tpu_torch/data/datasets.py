"""Datasets: numpy (T, H, W, C) float32 clips in model input space.

The port's own copy of the parts of ``meta_interpolation_tpu/data/
datasets.py`` this slice runs: Vimeo90K septuplets (reference
data/vimeo_septuplet.py:10-89), the procedural :class:`SyntheticSeptuplet`
and the :func:`get_dataset` dispatch with its fallback to synthetic data
when Vimeo90K is missing. Each dataset exposes ``switch_set(name)``,
``__len__`` and ``__getitem__(i) -> (frames, {'imgpaths': [...]})``.
"""
from __future__ import annotations

import os
import random
from typing import Dict, Optional, Tuple

import numpy as np

try:
    from PIL import Image
except ImportError:  # pragma: no cover
    Image = None


def normalize_for_model(img01: np.ndarray, model: str) -> np.ndarray:
    """[0,1] HWC float32 → model input space, via the registry's
    ``ModelDef.normalize``."""
    from ..models import registry
    return np.asarray(registry.get(model).normalize(img01), np.float32)


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

    def __getitem__(self, index):
        paths = self._paths(index)
        images = [load_image(p) for p in paths]
        if self.current_set_name == "train":
            h, w = images[0].shape[:2]
            ch, cw = min(self.crop_size, h), min(self.crop_size, w)
            oy = self.rng.randint(0, max(0, h - ch))
            ox = self.rng.randint(0, max(0, w - cw))
            images = [im[oy:oy + ch, ox:ox + cw] for im in images]
            if self.rng.random() >= 0.5:
                images, paths = images[::-1], paths[::-1]
        frames = np.stack([normalize_for_model(im, self.model)
                           for im in images])
        return frames, {"imgpaths": paths}


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
                crop_size: int = 256, **_kw):
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
    if name in ("middlebury", "davis", "hd", "snufilm", "test"):
        raise NotImplementedError(
            f"dataset {name!r} is not ported to PyTorch yet")
    raise NotImplementedError(f"dataset {name!r}")
