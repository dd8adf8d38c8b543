"""Prefetching batch loader.

The port's own copy of ``desenet_tpu/data/loader.py``: worker threads
decode and augment (numpy/PIL/cv2 release the GIL), batches are assembled
into fixed-shape arrays, and an optional ``stage`` callback (``to_device``:
pinned memory, then a non-blocking copy to the card) runs in the worker
thread, batches ahead of the step, so the device does not wait on the host.
Training shuffles with a per-epoch permutation seeded by (seed, epoch) and
may quad-collate; ``rank``/``world_size`` read a strided shard of the
epoch's order.
"""

from __future__ import annotations

import os
import queue
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from desenet_tpu_torch.data.dataset import MixedDataset, collate, collate_quad

ARRAY_KEYS = ("image", "det_targets", "det_mask", "seg_labels")


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
        quad: bool = False,
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
        # quad collate: groups of 4 samples become one 2x-size image; the
        # batch is (batch_size // 4, 2s, 2s)
        self.quad = quad
        if quad and batch_size % 4:
            raise ValueError("--quad needs batch_size % 4 == 0")

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        self.dataset.set_epoch(epoch)

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

        def make_batch(bidx, pos_list):
            samples = [self.dataset.get_sample(int(p)) for p in pos_list]
            if self.quad:
                rng = np.random.default_rng(np.random.SeedSequence(
                    [self.seed, self.epoch, int(bidx)]))
                batch = collate_quad(samples, self.max_targets, rng=rng)
            else:
                batch = collate(samples, self.max_targets)
            if self.stage is not None:
                batch = self.stage(batch)
            return batch

        with ThreadPoolExecutor(max_workers=self.workers) as pool:
            futures = queue.Queue()
            depth = min(self.prefetch * max(1, self.workers // 2), nb)
            it = enumerate(batches)
            for bi, bp in (next(it) for _ in range(depth)):
                futures.put(pool.submit(make_batch, bi, bp))
            for _ in range(nb):
                fut = futures.get()
                nxt = next(it, None)
                if nxt is not None:
                    futures.put(pool.submit(make_batch, *nxt))
                yield fut.result()


def to_device(device) -> Callable[[dict], dict]:
    """A ``stage`` callback: the batch's arrays to ``device`` as tensors,
    through pinned host memory and a non-blocking copy on a card (the
    copy is ordered before the step's kernels on the default stream);
    ``paths`` and ``shapes`` stay on the host."""
    dev = torch.device(device)
    pin = dev.type == "cuda"

    def stage(batch: dict) -> dict:
        out = dict(batch)
        for k in ARRAY_KEYS:
            t = torch.from_numpy(np.ascontiguousarray(batch[k]))
            out[k] = (t.pin_memory().to(dev, non_blocking=True) if pin
                      else t.to(dev))
        return out

    return stage


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
    fast_decode: bool = False,
    cache_images=None,
    quad: bool = False,
    hyp=None,
):
    """(loader, dataset) over ``path`` (an image dir, a txt listing or a
    list of either); ``augment=True`` is the training loader (shuffled,
    drop_last, augmented with ``hyp``); ``fast_decode`` and
    ``cache_images`` go to ``MixedDataset``."""
    dataset = MixedDataset(
        path, img_size=img_size, batch_size=batch_size, augment=augment,
        hyp=hyp, rect=rect, stride=stride, pad=pad, single_cls=single_cls,
        max_targets=max_targets, seed=seed, fast_decode=fast_decode,
        cache_images=cache_images,
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
        quad=quad,
    )
    return loader, dataset
