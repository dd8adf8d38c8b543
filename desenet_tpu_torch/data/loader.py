"""Prefetching batch loader.

The port's own copy of ``desenet_tpu/data/loader.py`` for the validation
path: worker threads decode and letterbox (numpy/PIL/cv2 release the GIL),
batches are assembled into fixed-shape arrays, and an optional ``stage``
callback runs one batch ahead, so the device does not wait on the host.
``rank``/``world_size`` read a strided shard of the epoch's order. The quad
collate is a training option and is not here.
"""

from __future__ import annotations

import os
import queue
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional

import numpy as np

from desenet_tpu_torch.data.dataset import MixedDataset, collate


def available_cores() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        return os.cpu_count() or 1


def _single_threaded_cv2() -> None:
    """The loader's thread pool provides the parallelism; cv2's internal
    threading on top of it oversubscribes cores. No cv2: nothing to do (no
    image needs resizing then either)."""
    try:
        import cv2
    except ImportError:
        return
    cv2.setNumThreads(0)


class DataLoader:
    def __init__(
        self,
        dataset: MixedDataset,
        batch_size: int,
        shuffle: bool = False,
        workers: int = 4,
        max_targets: int = 128,
        rank: int = 0,
        world_size: int = 1,
        drop_last: bool = False,
        stage: Optional[Callable] = None,
        prefetch: int = 2,
        seed: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle and not dataset.rect
        self.workers = max(1, workers)
        self.max_targets = max_targets
        self.rank = rank
        self.world_size = world_size
        self.drop_last = drop_last
        self.stage = stage
        self.prefetch = max(1, prefetch)
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _epoch_positions(self) -> np.ndarray:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            order = np.random.default_rng(
                np.random.SeedSequence([self.seed, self.epoch])
            ).permutation(n)
        return order[self.rank::self.world_size]

    def __len__(self):
        n = len(self._epoch_positions())
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self) -> Iterator[dict]:
        positions = self._epoch_positions()
        nb = len(self)
        batches = [
            positions[i * self.batch_size:(i + 1) * self.batch_size]
            for i in range(nb)
        ]

        _single_threaded_cv2()

        def make_batch(pos_list):
            samples = [self.dataset.get_sample(int(p)) for p in pos_list]
            batch = collate(samples, self.max_targets)
            if self.stage is not None:
                batch = self.stage(batch)
            return batch

        with ThreadPoolExecutor(max_workers=self.workers) as pool:
            futures = queue.Queue()
            depth = min(self.prefetch * max(1, self.workers // 2), nb)
            it = iter(batches)
            for bp in (next(it) for _ in range(depth)):
                futures.put(pool.submit(make_batch, bp))
            for _ in range(nb):
                fut = futures.get()
                bp = next(it, None)
                if bp is not None:
                    futures.put(pool.submit(make_batch, bp))
                yield fut.result()


def create_mixed_dataloader(
    path,
    img_size: int = 640,
    batch_size: int = 16,
    augment: bool = False,
    rect: bool = False,
    stride: int = 32,
    pad: float = 0.0,
    single_cls: bool = False,
    workers: int = 8,
    max_targets: int = 128,
    rank: int = 0,
    world_size: int = 1,
    shuffle: Optional[bool] = None,
    stage=None,
    seed: int = 0,
):
    """(loader, dataset) over ``path`` (an image dir, a txt listing or a
    list of either). ``augment=True`` raises NotImplementedError
    (``MixedDataset``)."""
    dataset = MixedDataset(
        path, img_size=img_size, batch_size=batch_size, augment=augment,
        rect=rect, stride=stride, pad=pad, single_cls=single_cls,
        max_targets=max_targets,
    )
    # cap at 2x the cores actually schedulable: decode threads release the
    # GIL but oversubscribing a small host regresses throughput
    loader = DataLoader(
        dataset,
        batch_size=batch_size,
        shuffle=augment if shuffle is None else shuffle,
        workers=min(workers, batch_size, 8, 2 * available_cores()),
        max_targets=max_targets,
        rank=rank,
        world_size=world_size,
        drop_last=augment,
        stage=stage,
        seed=seed,
    )
    return loader, dataset
