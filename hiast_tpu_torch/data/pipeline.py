"""Batch assembly with background prefetch.

The port's copy of ``hiast_tpu/data/pipeline.py``, kept line for line so the
numpy shuffle order, and with it the order in which IAS sees the images, is
the JAX CLI's exactly.  ONE host pipeline produces the global batch; a
daemon thread decodes the next batches while the card runs the current one.  (``infinite_batches``, the training stream, comes with the
training slice.)
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np


def collate(samples: list[dict]) -> dict:
    batch = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray):
            batch[key] = np.stack(vals)
        else:
            batch[key] = vals
    return batch


def pad_batch(batch: dict, target: int, label_keys=("labels",)) -> dict:
    """Pad a partial batch to ``target`` samples so every batch hits ONE
    compiled shape (a tail batch otherwise triggers a fresh XLA compile —
    30-100 s through slow-compile links — and falls off the data-sharded
    path).

    Array leaves are padded along axis 0 — labels with 255 (ignore: padded
    samples contribute NOTHING to IoU/stats by construction), everything
    else with zeros.  List leaves (image paths) keep their true length, so
    downstream zip-style consumers are automatically trimmed.  The true
    sample count is recorded under ``n_valid``.
    """
    n = None
    for v in batch.values():
        if isinstance(v, np.ndarray):
            n = v.shape[0]
            break
    if n is None or n >= target:
        return {**batch, "n_valid": n if n is not None else 0}
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            fill = 255 if k in label_keys else 0
            pad = np.full((target - n,) + v.shape[1:], fill, v.dtype)
            out[k] = np.concatenate([v, pad], axis=0)
        else:
            out[k] = v
    out["n_valid"] = n
    return out


class BatchIterator:
    """One epoch of shuffled, collated batches.

    ``num_workers`` > 0 fetches the samples of a batch through a thread pool
    — decode/resize/paste run in C (PIL/cv2/native ops) with the GIL
    released, so threads scale on multi-core hosts (the TPU-host analog of
    the reference's DataLoader worker processes).  Pass ``pool`` to reuse an
    existing executor (infinite_batches shares ONE pool across epochs
    instead of churning a fresh pool per epoch).
    """

    def __init__(
        self, dataset, batch_size, shuffle=True, seed=0, epoch=0, drop_last=True,
        num_workers: int = 0, pool=None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = epoch
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.pool = pool

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _fetch(self, i: int) -> dict:
        rng = np.random.default_rng((self.seed, self.epoch, int(i)))
        return self.dataset.get_item(int(i), rng)

    def __iter__(self) -> Iterator[dict]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng((self.seed, self.epoch)).shuffle(order)
        limit = (n // self.batch_size) * self.batch_size if self.drop_last else n
        pool, own_pool = self.pool, False
        if pool is None and self.num_workers > 0:
            from concurrent.futures import ThreadPoolExecutor

            pool = ThreadPoolExecutor(max_workers=self.num_workers)
            own_pool = True
        try:
            for start in range(0, limit, self.batch_size):
                idxs = [int(i) for i in order[start : start + self.batch_size]]
                if pool is not None:
                    samples = list(pool.map(self._fetch, idxs))
                else:
                    samples = [self._fetch(i) for i in idxs]
                yield collate(samples)
        finally:
            if own_pool:
                pool.shutdown(wait=True)


def prefetched(iterator: Iterator, depth: int = 2) -> Iterator:
    """Run `iterator` in a daemon thread, buffering `depth` items."""
    if depth <= 0:
        yield from iterator
        return
    q: queue.Queue = queue.Queue(maxsize=depth)
    _SENTINEL = object()

    def worker():
        try:
            for item in iterator:
                q.put(item)
        except BaseException as e:  # propagate into the consumer
            q.put(("__error__", e))
        q.put(_SENTINEL)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _SENTINEL:
            return
        if isinstance(item, tuple) and len(item) == 2 and item[0] == "__error__":
            raise item[1]
        yield item
