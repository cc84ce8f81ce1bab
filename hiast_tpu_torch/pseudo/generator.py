"""Pseudo-label generators (the round-contract artifact writers).

The port of ``hiast_tpu/pseudo/generator.py``.  Drives the policy math over
the target dataset and writes the cross-round artifact set the training side
consumes (reference: code/workflows/pseudo_label_generator.py:48-62):

    <save_dir>/<image>_pseudo_label.png      gray uint8 label maps
    <save_dir>/../class_threshold.npy        final per-class thresholds
    <save_dir>/../statics_class.npy          total selected pixels per class
    <save_dir>/../class_mean_probabilities.npy  EMA of selected-pixel confidence
    <save_dir>/../sample_class_stats.json    per-image per-class pixel counts
    <save_dir>/../samples_with_class.json    {class: [[image, pixels], ...]}

The policies (``PSEUDO_POLICY``):

- ``IAS``, the instance-adaptive selector: per batch on the card the
  forward, the ``ias_hist`` kernel, the IAS threshold update, the
  ``ias_select`` kernel and the class-mean EMA, all queued without a
  synchronisation;
- ``CT``, one constant threshold for every class, and ``NT``, no threshold
  (every valid pixel; the kernel gets zeros, and no ``class_threshold.npy``
  is written): ``ias_select`` only;
- ``CBST``: a first pass sums ``ias_hist`` over the whole target set (in
  float64), the class-balanced thresholds come from that histogram, and a
  second pass selects with ``ias_select``.  Both passes draw the same order.

The host copies the uint8 label maps back one batch late and writes the
PNGs on a thread pool.

Under a process group (``parallel/mesh.py``) each rank takes its
contiguous share of every global batch, padded to a multiple of the world
size, with its own valid-pixel count (0 where its whole share is padding).
The kernels' histograms, counts and confidence sums are summed over the
ranks before the policy's update, so the carried state is the same on every
rank, as JAX's replicated state is; the confidence sums travel as float64
(the kernel's fixed-point total), so they round once to float32, as at
world size 1.  Each rank writes the PNGs of its samples; rank 0 decides
whether the output dir is done or must be prepared, gathers every rank's
per-sample counts in the global order and writes the statistics files.
"""
from __future__ import annotations

import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable

import numpy as np
import torch

from hiast_tpu_torch.data.pipeline import pad_batch
from hiast_tpu_torch.data.png import write_png
from hiast_tpu_torch.ops.cuda.select_kernel import ias_hist, ias_select
from hiast_tpu_torch.parallel import mesh
from hiast_tpu_torch.pseudo import policies as P
from hiast_tpu_torch.registry import PSEUDO_POLICY


def _summed_select_stats(sums: torch.Tensor, counts: torch.Tensor):
    """(confidence sums [C] float32, selected pixels [C] float32) of the
    global batch, from this rank's float64 ``ias_select`` sums and [b, C]
    counts: summed over the ranks, then rounded once."""
    totals = counts.sum(0).double()
    mesh.all_reduce_sum([sums, totals])
    return sums.float(), totals.float()


class BasePseudoGenerator:
    """Drives batches through a selection step and writes artifacts.

    ``forward_fn(images_uint8)`` encapsulates the model and returns either
    full-res NCHW logits [B, C, H, W] float32 or a dict {'full': ..., 'low':
    ...} where 'low' is the pre-upsample OS8 logits grid, used for threshold
    statistics when ``pseudo_policy.stats_source == 'low'``.  ``data_iter``
    yields {'images': uint8 [B,H,W,3], 'image_paths': [str]}.  ``device`` is
    where the carried policy state lives: the device of the logits.
    """

    def __init__(
        self,
        cfg,
        forward_fn: Callable,
        data_iter_factory: Callable[[], Iterable],
        expected_count: int | None = None,
        device: torch.device | str = "cuda",
    ):
        self.cfg = cfg
        self.forward_fn = forward_fn
        self.data_iter_factory = data_iter_factory
        self.expected_count = expected_count
        self.device = torch.device(device)
        self.num_classes = cfg.dataset.num_classes
        self.num_bins = cfg.pseudo_policy.num_hist_bins
        self.save_dir = cfg.pseudo_policy.save_dir
        if not self.save_dir:
            raise ValueError("pseudo_policy.save_dir must be set")
        self.stats_dir = os.path.dirname(os.path.normpath(self.save_dir))

        self.statics_class = np.zeros(self.num_classes, np.int64)
        self.sample_stats: list[dict] = []
        self.samples_class: dict[int, list] = {c: [] for c in range(self.num_classes)}
        self._records: list[list] = []  # a batch's [(path, {class: pixels})], this rank's samples
        self.class_mean_probs = np.zeros(self.num_classes, np.float32)
        self.class_threshold: np.ndarray | None = None
        self.run_seconds: float | None = None  # wall time of the last run()
        self._png_pool = ThreadPoolExecutor(max_workers=2)
        self._png_futures: list = []

    def _pad(self, batch):
        """Pad a partial tail batch to ``pseudo_policy.batch_size`` (this
        rank's share of it under a process group).  Returns (images,
        n_valid, image_paths): the pad samples are a suffix, masked out of
        every statistic by a valid-pixel count, and ``image_paths`` keeps
        its true length, so ``_record_batch``'s zip drops them from every
        written artifact."""
        size = self.cfg.pseudo_policy.batch_size
        target = -(-size // mesh.world_size()) if size else batch["images"].shape[0]
        padded = pad_batch(batch, target)
        return padded["images"], int(padded["n_valid"]), batch["image_paths"]

    def _forward(self, images):
        """Normalize forward_fn output to (logits_full, logits_stats)."""
        out = self.forward_fn(images)
        if isinstance(out, dict):
            full = out["full"]
            low = out.get("low", full)
        else:
            full = low = out
        use_low = self.cfg.pseudo_policy.stats_source == "low"
        return full, (low if use_low else full)

    # -- host-side bookkeeping ---------------------------------------------
    def _record_batch(self, plbl_np, counts_np, image_paths):
        records = []
        for img_path, counts, plbl in zip(image_paths, counts_np, plbl_np):
            records.append((img_path, {int(c): int(counts[c]) for c in np.nonzero(counts)[0]}))
            name = os.path.splitext(os.path.basename(img_path))[0]
            # PNG encoding overlaps the next batch (zlib releases the GIL)
            self._png_futures.append(
                self._png_pool.submit(
                    write_png, os.path.join(self.save_dir, f"{name}_pseudo_label.png"), plbl
                )
            )
        self._records.append(records)

    def _collect_stats(self):
        """The per-sample statistics of every rank, in the global order:
        batch by batch, each batch's shares in rank order."""
        for batch in zip(*mesh.gather_objects(self._records)):
            for img_path, current in (rec for share in batch for rec in share):
                for c, n in current.items():
                    self.samples_class[c].append([img_path, n])
                    self.statics_class[c] += n
                self.sample_stats.append({**current, "file": img_path})
        self._records = []

    def _drain_writers(self):
        for f in self._png_futures:
            f.result()
        self._png_futures = []

    def save_data(self):
        self._drain_writers()
        self._png_pool.shutdown(wait=True)
        self._collect_stats()
        if mesh.is_main():
            self._write_stats()
        mesh.barrier()

    def _write_stats(self):
        if self.class_threshold is not None:
            np.save(os.path.join(self.stats_dir, "class_threshold.npy"), self.class_threshold)
        np.save(os.path.join(self.stats_dir, "statics_class.npy"), self.statics_class)
        np.save(
            os.path.join(self.stats_dir, "class_mean_probabilities.npy"),
            self.class_mean_probs,
        )
        with open(os.path.join(self.stats_dir, "sample_class_stats.json"), "w") as f:
            json.dump(self.sample_stats, f)
        with open(os.path.join(self.stats_dir, "samples_with_class.json"), "w") as f:
            json.dump(self.samples_class, f)

    def already_done(self, n_expected: int | None = None) -> bool:
        """Idempotency: skip regeneration when the output dir is fully
        populated (reference pseudo_label_generator.py:116-117,182-183)."""
        if not os.path.isdir(self.save_dir):
            return False
        n = len(os.listdir(self.save_dir))
        if n_expected is None:
            n_expected = self.expected_count
        return n_expected is not None and n >= n_expected

    def prepare_dirs(self):
        """Create (or RECOVER) the output dir.  Reached only when
        ``already_done()`` said incomplete: a non-empty dir here is an
        interrupted previous generation.  The IAS state is sequential over
        the dataset, so the partial output is cleared and generation restarts
        from scratch.  Only files this generator writes
        (``*_pseudo_label.png``) are ever deleted; anything else in the dir
        fails loudly."""
        os.makedirs(self.save_dir, exist_ok=True)
        entries = os.listdir(self.save_dir)
        if not entries:
            return
        foreign = [e for e in entries if not e.endswith("_pseudo_label.png")]
        if foreign:
            raise RuntimeError(
                f"pseudo-label dir {self.save_dir} contains files this generator "
                f"did not write (e.g. {foreign[:3]}); refusing to clear it"
            )
        print(
            f"%% pseudo-label dir {self.save_dir} is partially populated "
            f"({len(entries)} files) — clearing and regenerating from scratch"
        )
        for e in entries:
            os.unlink(os.path.join(self.save_dir, e))

    @staticmethod
    def _start_fetch(plbl: torch.Tensor, counts: torch.Tensor):
        """Queue the copy of a batch's outputs to the host behind its kernels
        (pinned buffers, no wait); ``_finish_fetch`` waits for it."""
        if plbl.device.type != "cuda":
            return plbl, counts, None
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in (plbl, counts)]
        for h, t in zip(host, (plbl, counts)):
            h.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host[0], host[1], done

    @staticmethod
    def _finish_fetch(fetch):
        plbl, counts, done = fetch
        if done is not None:
            done.synchronize()
        return plbl.numpy(), counts.numpy()

    def _run_select_loop(self, step: Callable):
        """Drive ``step(batch) -> (plbl, counts, paths)`` over the dataset one
        batch deep: batch k+1 is queued on the card before batch k's label
        maps are read on the host, so the copy and the PNG writes overlap the
        next batch's compute.  ``paths`` may be shorter than the (padded)
        batch; ``_record_batch`` zips, dropping pad rows."""
        prev = None
        for batch in self.data_iter_factory():
            plbl, counts, paths = step(batch)
            fetch = self._start_fetch(plbl, counts)
            if prev is not None:
                self._record_batch(*self._finish_fetch(prev[0]), prev[1])
            prev = (fetch, paths)
        if prev is not None:
            self._record_batch(*self._finish_fetch(prev[0]), prev[1])

    def generate(self) -> None:
        """The policy's passes over the dataset; sets ``class_threshold``
        (None: not written) and ``class_mean_probs``."""
        raise NotImplementedError

    def run(self):
        if mesh.broadcast_object(self.already_done() if mesh.is_main() else None):
            print(f"%% pseudo labels already exist in {self.save_dir}; skipping")
            return
        if mesh.is_main():
            self.prepare_dirs()
        mesh.barrier()
        start = time.perf_counter()
        self.generate()
        self.save_data()
        self.run_seconds = time.perf_counter() - start
        n = len(self.sample_stats)
        print(f"%% {self.cfg.pseudo_policy.type}: {n} images in {self.run_seconds:.3f} s "
              f"({n / self.run_seconds:.2f} images/s)")


@PSEUDO_POLICY.register("CT")
class ConstantThresholdGenerator(BasePseudoGenerator):
    """One threshold for every class (``pseudo_policy.ct.threshold``)."""

    def initial_thresholds(self) -> torch.Tensor | None:
        return torch.full((self.num_classes,), self.cfg.pseudo_policy.ct.threshold,
                          dtype=torch.float32, device=self.device)

    def generate(self):
        thresholds = self.initial_thresholds()
        # NT: zeros select every valid pixel, as JAX's thresholds=None does
        select_thr = thresholds if thresholds is not None else torch.zeros(
            self.num_classes, dtype=torch.float32, device=self.device)
        cmp = torch.zeros(self.num_classes, dtype=torch.float32, device=self.device)

        def step(batch):
            nonlocal cmp
            images, n_valid, paths = self._pad(batch)
            full, _ = self._forward(images)
            plbl, counts, sums, _ = ias_select(full, select_thr, n_valid * full.shape[2] * full.shape[3])
            sums, totals = _summed_select_stats(sums, counts)
            cmp = P.update_class_mean_probs(cmp, sums, totals, self.cfg.preprocessor.copy_paste.gamma)
            return plbl, counts, paths

        self._run_select_loop(step)
        self.class_mean_probs = cmp.cpu().numpy()
        if thresholds is not None:
            self.class_threshold = thresholds.cpu().numpy()


@PSEUDO_POLICY.register("NT")
class NoThresholdGenerator(ConstantThresholdGenerator):
    """Every valid pixel is its argmax; no ``class_threshold.npy``."""

    def initial_thresholds(self):
        return None


@PSEUDO_POLICY.register("CBST")
class CBSTGenerator(ConstantThresholdGenerator):
    """Two passes: the dataset's per-class histogram, then selection."""

    def initial_thresholds(self):
        # float64: a float32 sum of per-batch counts stops being exact past
        # 2^24 pixels of a bin, which a full target set passes
        hist = torch.zeros((self.num_classes, self.num_bins), dtype=torch.float64, device=self.device)
        for batch in self.data_iter_factory():
            images, n_valid, _ = self._pad(batch)
            _, stats = self._forward(images)
            hist += ias_hist(stats, n_valid * stats.shape[2] * stats.shape[3], self.num_bins)
        mesh.all_reduce_sum([hist])
        return P.cbst_thresholds(hist, self.cfg.pseudo_policy.cbst.p)


@PSEUDO_POLICY.register("IAS")
class IASGenerator(BasePseudoGenerator):
    """Instance-adaptive selector: thresholds are carried state, updated
    per batch BEFORE selection (reference pseudo_label_generator.py:181-213)."""

    def _ias_step(self, logits_full, logits_stats, state: P.IASState, n_valid: int):
        """Thresholds from the stats grid, selection at full resolution.
        The pad samples are a suffix of the b-major pixel order, so the
        kernels mask them with a valid-pixel count."""
        ias = self.cfg.pseudo_policy.ias
        stats_pixels = logits_stats.shape[2] * logits_stats.shape[3]
        hist = ias_hist(logits_stats, n_valid * stats_pixels, self.num_bins)
        new_thr = P.ias_update(state, mesh.all_reduce_sum([hist])[0], ias.alpha, ias.beta, ias.gamma)
        full_pixels = logits_full.shape[2] * logits_full.shape[3]
        plbl, counts, sums, _ = ias_select(logits_full, new_thr, n_valid * full_pixels)
        sums, totals = _summed_select_stats(sums, counts)
        new_cmp = P.update_class_mean_probs(
            state.class_mean_probs, sums, totals, self.cfg.preprocessor.copy_paste.gamma,
        )
        return plbl, counts, P.IASState(new_thr, new_cmp)

    def generate(self):
        state = P.IASState(
            thresholds=torch.full((self.num_classes,), 0.9, dtype=torch.float32, device=self.device),
            class_mean_probs=torch.zeros(self.num_classes, dtype=torch.float32, device=self.device),
        )

        def step(batch):
            nonlocal state
            images, n_valid, paths = self._pad(batch)
            full, stats_logits = self._forward(images)
            plbl, counts, state = self._ias_step(full, stats_logits, state, n_valid)
            return plbl, counts, paths

        self._run_select_loop(step)
        self.class_threshold = state.thresholds.cpu().numpy()
        self.class_mean_probs = state.class_mean_probs.cpu().numpy()
