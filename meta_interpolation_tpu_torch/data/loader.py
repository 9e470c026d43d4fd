"""Task batching with a thread pool and a background prefetch thread.

The port's own copy of ``meta_interpolation_tpu/data/loader.py:18-241``.
A producer thread assembles each batch with ``num_workers`` threads
(PIL's decode releases the GIL) and keeps up to ``prefetch`` batches ahead
of the episode. A dataset with ``get_raw`` (Vimeo90K) takes the native
path: uint8 decode in the pool, then one C++ call (``data/native``) for
crop, flip, normalisation and batching; without the library it takes the
numpy path. A seeded augmentation stream is drawn serially in batch order
on either path, so batches do not depend on thread scheduling.
"""
from __future__ import annotations

import copy
import queue
import threading
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Tuple

import numpy as np


class TaskLoader:
    """Iterate (B, T, H, W, C) float32 batches from a dataset."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 num_workers: int = 4, seed: int = 0, drop_last: bool = False,
                 prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self._epoch = 0
        self._norm_ok: Optional[bool] = None

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def _indices(self) -> List[int]:
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            np.random.RandomState(self.seed + self._epoch).shuffle(idx)
        return idx

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _native_norm_ok(self) -> bool:
        """Whether the dataset's C++ constants, (u8·inv255 − mean)/std,
        reproduce the registry's ``ModelDef.normalize`` for its model
        (checked once): a model whose normalisation the affine form cannot
        express takes the numpy path, with a warning."""
        if self._norm_ok is None:
            ds = self.dataset
            if not hasattr(ds, "norm_constants"):
                self._norm_ok = False
            else:
                from .datasets import normalize_for_model
                mean, std, inv255 = ds.norm_constants()
                probe = (np.arange(6, dtype=np.float32)
                         .reshape(2, 1, 3) * 51.0)
                expected = normalize_for_model(probe / 255.0, ds.model)
                got = (probe * inv255 - mean) / std
                self._norm_ok = bool(np.allclose(expected, got, atol=1e-5))
                if not self._norm_ok:
                    warnings.warn(
                        f"native prep constants do not reproduce "
                        f"ModelDef.normalize for model {ds.model!r}; "
                        f"using the python data path")
        return self._norm_ok

    def _native_batch(self, pool, batch_idx):
        """The native path: uint8 decode in the pool, then one C++ call.
        None where it does not apply (no library, no ``get_raw``, constants
        that do not reproduce the model's normalisation, frames of
        different shapes)."""
        from . import native
        ds = self.dataset
        if not hasattr(ds, "get_raw") or native.load() is None:
            return None
        if not self._native_norm_ok():
            return None
        items = list(pool.map(ds.get_raw, batch_idx))
        raw = [it[0] for it in items]
        meta = [it[1] for it in items]
        if any(r.shape != raw[0].shape for r in raw):
            return None
        h, w = raw[0].shape[1], raw[0].shape[2]
        augs = [ds.aug_params(h, w) for _ in raw]
        crop_h, crop_w = augs[-1][3:]
        mean, std, inv255 = ds.norm_constants()
        # a temporal flip flips the paths too (reference
        # vimeo_septuplet.py:64-67)
        for i, aug in enumerate(augs):
            if aug[2]:
                meta[i] = {"imgpaths": list(meta[i]["imgpaths"])[::-1]}
        frames = native.prep_batch(
            np.stack(raw), crop_h, crop_w, np.asarray([a[0] for a in augs]),
            np.asarray([a[1] for a in augs]),
            np.asarray([a[2] for a in augs]), mean, std, inv255,
            num_threads=self.num_workers)
        return frames, meta

    def _numpy_batch(self, pool, batch_idx):
        ds = self.dataset
        if hasattr(ds, "getitem_with_aug") and hasattr(ds, "aug_params"):
            # the seeded augmentation stream, drawn here in batch order
            hw = ds.frame_hw()
            augs = [ds.aug_params(*hw) for _ in batch_idx]
            items = list(pool.map(lambda a: ds.getitem_with_aug(*a),
                                  zip(batch_idx, augs)))
        else:
            items = list(pool.map(ds.__getitem__, batch_idx))
        return (np.stack([it[0] for it in items]), [it[1] for it in items])

    def __iter__(self) -> Iterator[Tuple[np.ndarray, list]]:
        indices = self._indices()
        batches = [indices[i:i + self.batch_size]
                   for i in range(0, len(indices), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        if not batches:
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        errors: List[BaseException] = []

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for batch_idx in batches:
                        if stop.is_set():
                            return
                        item = self._native_batch(pool, batch_idx)
                        if item is None:
                            item = self._numpy_batch(pool, batch_idx)
                        q.put(item)
            except Exception as e:  # re-raised in the consumer below
                errors.append(e)
            finally:
                q.put(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                yield item
            if errors:
                raise errors[0]
        finally:
            stop.set()
            while t.is_alive():  # drain so the producer can exit
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            t.join()


class MetaLearningSystemDataLoader:
    """Reference loader API (data/__init__.py:520-625): train / val / test
    batch generators over one dataset.

    ``mesh_task_size``: the task axis of a task-parallel run. Above 1 the
    tail partial train batch is dropped, since each train batch must
    split evenly over the ranks (JAX :178-212); evaluation keeps every
    clip (a partial batch runs whole on every rank). Every rank builds the
    same global batches, from one seed and one shuffle."""

    def __init__(self, cfg, mesh_task_size: int = 1):
        from .datasets import get_dataset
        self.cfg = cfg
        self.dataset = get_dataset(cfg.dataset, cfg.data_root, cfg.model,
                                   cfg.mode, crop_size=cfg.crop_size,
                                   test_mode=cfg.test_mode,
                                   img_fmt=cfg.img_fmt)
        self.batch_size = {"train": cfg.batch_size,
                           "val": cfg.val_batch_size,
                           "test": cfg.test_batch_size}
        self.num_workers = cfg.num_workers
        self.seed = cfg.random_seed
        self.mesh_task_size = max(1, int(mesh_task_size))

    def _batches(self, mode: str, total_batches: int, epoch: int = 0):
        # per-split shallow copy: switch_set mutates current_set_name
        dataset = copy.copy(self.dataset)
        dataset.switch_set(mode)
        loader = TaskLoader(dataset, self.batch_size[mode],
                            shuffle=(mode == "train"),
                            num_workers=self.num_workers, seed=self.seed,
                            drop_last=(mode == "train"
                                       and self.mesh_task_size > 1))
        loader.set_epoch(epoch)
        for count, batch in enumerate(loader, 1):
            yield batch
            if 0 < total_batches <= count:
                break

    def get_train_batches(self, total_batches: int = -1, epoch: int = 0):
        return self._batches("train", total_batches, epoch)

    def get_val_batches(self, total_batches: int = -1):
        return self._batches("val", total_batches)

    def get_test_batches(self, total_batches: int = -1):
        return self._batches("test", total_batches)
