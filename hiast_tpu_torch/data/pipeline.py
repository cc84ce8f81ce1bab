"""Batch assembly with background prefetch.

The port's copy of ``hiast_tpu/data/pipeline.py``, kept line for line so the
numpy shuffle order, and with it the order in which IAS sees the images and
the trainer its batches, is the JAX package's exactly.  ONE host pipeline
produces the global batch; a daemon thread decodes the next batches while
the card runs the current one.  Two departures: ``infinite_batches`` raises
when the dataset holds fewer samples than a batch, where the JAX stream
would spin forever without yielding (every epoch drops its only, partial
batch); and ``BatchIterator``'s ``share`` gives a data-parallel rank its
rows of each global batch (``parallel/mesh.py``), where the JAX package
shards the global batch on the device.
"""
from __future__ import annotations

import os
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

    ``share`` (rank r, world size N) yields rank r's contiguous share of
    each global batch instead: the batch padded to a multiple of N and cut
    into N equal parts, as JAX shards it over the data axis.  The pad rows
    are not fetched, so a share holds 0 to ``local_size`` samples; an empty
    one keeps the arrays' trailing shapes with 0 rows, for ``pad_batch``.
    """

    def __init__(
        self, dataset, batch_size, shuffle=True, seed=0, epoch=0, drop_last=True,
        num_workers: int = 0, pool=None, share: tuple[int, int] | None = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = epoch
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.pool = pool
        self.share = share

    @property
    def local_size(self) -> int:
        """Rows of a (padded) batch on this rank."""
        return self.batch_size if self.share is None else -(-self.batch_size // self.share[1])

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
        fetch = (lambda idxs: list(pool.map(self._fetch, idxs))) if pool is not None else (
            lambda idxs: [self._fetch(i) for i in idxs])
        template = None
        try:
            for start in range(0, limit, self.batch_size):
                idxs = [int(i) for i in order[start : start + self.batch_size]]
                if self.share is not None:
                    r = self.share[0]
                    idxs = idxs[r * self.local_size : (r + 1) * self.local_size]
                    if not idxs:  # all of this rank's rows are padding
                        template = template or collate([self._fetch(int(order[start]))])
                        yield {k: v[:0] if isinstance(v, np.ndarray) else [] for k, v in template.items()}
                        continue
                batch = collate(fetch(idxs))
                template = batch
                yield batch
        finally:
            if own_pool:
                pool.shutdown(wait=True)


def infinite_batches(dataset, batch_size, seed=0, prefetch=2, num_workers=None) -> Iterator[dict]:
    """Endless stream of train batches, reshuffled per (seed, epoch), each
    sample's augmentation drawn from its own (seed, epoch, index) stream,
    with ``prefetch`` batches assembled ahead by a daemon thread.  One
    thread pool serves every epoch."""
    if len(dataset) < batch_size:
        raise ValueError(
            f"the dataset has {len(dataset)} samples, fewer than one batch of {batch_size}: "
            "every epoch would drop its only (partial) batch and the stream would never yield"
        )
    if num_workers is None:
        num_workers = min(batch_size, max((os.cpu_count() or 1) - 1, 0))

    def produce():
        pool = None
        if num_workers > 0:
            from concurrent.futures import ThreadPoolExecutor

            pool = ThreadPoolExecutor(max_workers=num_workers)
        epoch = 0
        while True:
            yield from BatchIterator(
                dataset, batch_size, shuffle=True, seed=seed, epoch=epoch,
                num_workers=num_workers, pool=pool,
            )
            epoch += 1

    return prefetched(produce(), prefetch)


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
