"""Task batching with a background prefetch thread.

The port's own copy of ``meta_interpolation_tpu/data/loader.py:18-241``,
without its thread pool and C++ prep: one producer thread loads clips in
order (so a dataset's seeded augmentation stream stays deterministic) and
keeps up to ``prefetch`` batches ahead of the episode.
"""
from __future__ import annotations

import copy
import queue
import threading
from typing import Iterator, List, Tuple

import numpy as np


class TaskLoader:
    """Iterate (B, T, H, W, C) float32 batches from a dataset."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = False, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self._epoch = 0

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
                for batch_idx in batches:
                    if stop.is_set():
                        return
                    items = [self.dataset[i] for i in batch_idx]
                    q.put((np.stack([it[0] for it in items]),
                           [it[1] for it in items]))
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
    batch generators over one dataset."""

    def __init__(self, cfg):
        from .datasets import get_dataset
        self.cfg = cfg
        self.dataset = get_dataset(cfg.dataset, cfg.data_root, cfg.model,
                                   cfg.mode, crop_size=cfg.crop_size,
                                   test_mode=cfg.test_mode,
                                   img_fmt=cfg.img_fmt)
        self.batch_size = {"train": cfg.batch_size,
                           "val": cfg.val_batch_size,
                           "test": cfg.test_batch_size}
        self.seed = cfg.random_seed

    def _batches(self, mode: str, total_batches: int, epoch: int = 0):
        # per-split shallow copy: switch_set mutates current_set_name
        dataset = copy.copy(self.dataset)
        dataset.switch_set(mode)
        loader = TaskLoader(dataset, self.batch_size[mode],
                            shuffle=(mode == "train"), seed=self.seed)
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
