"""Batching for evaluation: samples -> batch dicts, in dataset order.

The port of the evaluation part of `structuredetector_tpu/data/
pipeline.py` (`collate` and the per-sample branch of `Loader`). The
shuffling, multi-host and native whole-batch loading of the JAX
`Loader` belong to the training slice of the port.
"""

from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np


def collate(samples: Sequence[dict]) -> dict:
    """Stack per-sample dicts into a batch dict of numpy arrays;
    'annotation' stays a Python list (reference collate_fn,
    dataset.py:57-87)."""
    batch: dict = {}
    for key in samples[0]:
        if key == "annotation":
            batch[key] = [s[key] for s in samples]
        else:
            batch[key] = np.stack([s[key] for s in samples])
    return batch


PREFETCH_BATCHES = 4  # batches of sample loads in flight ahead of the consumer


class Loader:
    """Batches of `dataset[i]` in index order.

    With `num_workers > 0`, every sample load is a task on a thread pool
    of that size (PIL's decode and resize and the numpy work release the
    GIL), and up to `PREFETCH_BATCHES` batches of loads stay in flight."""

    def __init__(self, dataset, batch_size: int = 1, num_workers: int = 0):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = num_workers

    def __len__(self):
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def _index_batches(self):
        n = len(self.dataset)
        return [list(range(i, min(i + self.batch_size, n)))
                for i in range(0, n, self.batch_size)]

    def __iter__(self):
        batches = self._index_batches()
        if self.num_workers <= 0:
            for idxs in batches:
                yield collate([self.dataset[i] for i in idxs])
            return
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            inflight: collections.deque = collections.deque()
            it = iter(batches)

            def stage_next():
                idxs = next(it, None)
                if idxs is not None:
                    inflight.append([pool.submit(self.dataset.__getitem__, i) for i in idxs])

            for _ in range(PREFETCH_BATCHES):
                stage_next()
            while inflight:
                futures = inflight.popleft()
                samples = [f.result() for f in futures]
                stage_next()
                yield collate(samples)
