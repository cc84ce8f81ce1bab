"""Training workflows (TRAINER registry).

The port of ``hiast_tpu/selftrain/trainers.py`` (reference:
code/workflows/trainer/*.py): ``BaseTrainer`` assembles model, optimizer,
data streams, recorder and checkpoint policy; ``SelfTrainingTrainer`` trains
on the previous round's pseudo-labels.  One device, one process; the
consistency, mutual-learning and warmup trainers come with their slices.

The loop keeps the JAX trainer's one-batch-deep pipeline: it enqueues step
k on the card, then assembles and uploads batch k+1 (from pinned memory, so
the copy does not wait for the step) while the card works, then fetches
step k's losses.
"""
from __future__ import annotations

import json
import os
import signal
import time

import numpy as np
import torch

from hiast_tpu_torch.data.datasets import build_dataset
from hiast_tpu_torch.data.pipeline import BatchIterator, infinite_batches, prefetched
from hiast_tpu_torch.evaluation import make_val_step, run_validation
from hiast_tpu_torch.models.segmentors import build_segmentor
from hiast_tpu_torch.registry import TRAINER
from hiast_tpu_torch.selftrain import steps as S
from hiast_tpu_torch.selftrain.train_state import lr_schedule, make_optimizer
from hiast_tpu_torch.utils.checkpoint import CheckpointPolicy, load_train_state, load_weights
from hiast_tpu_torch.utils.logging_utils import init_logger, init_writer
from hiast_tpu_torch.utils.recorder import ResultRecorder

COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class BaseTrainer:
    """Common assembly: model, optimizer, data, recorder, checkpoint policy."""

    needs_target = False

    def __init__(self, cfg, device: torch.device | str = "cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.assert_cfg()
        self.initialize()
        self.build_all_model()
        self.build_train_data_reader()
        self.build_val_data_reader()

    # -- hooks ---------------------------------------------------------------
    def assert_cfg(self):
        pass

    def make_step(self):
        raise NotImplementedError

    def next_batch(self) -> dict:
        raise NotImplementedError

    # -- assembly ------------------------------------------------------------
    def initialize(self):
        cfg = self.cfg
        np.random.seed(cfg.train.random_seed)
        torch.manual_seed(cfg.train.random_seed)
        os.makedirs(cfg.work_dir, exist_ok=True)
        with open(os.path.join(cfg.work_dir, "config.json"), "w") as f:
            json.dump(cfg.to_dict(), f, indent=1)
        self.logger = init_logger(os.path.join(cfg.work_dir, "train.log"))
        self.writer = init_writer(os.path.join(cfg.work_dir, "tensorboard"))
        self.ckpt = CheckpointPolicy(
            os.path.join(cfg.work_dir, "checkpoints"), cfg.train.total_iter,
            cfg.train.is_save_all, keep=cfg.runtime.checkpoint.keep,
        )
        if self.device.type == "cuda":
            # the trunk runs under bf16 autocast; the float32 work around it
            # (losses, resizes, optimizer) is meant at full float32 precision
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.dtype = COMPUTE_DTYPES[cfg.runtime.precision.compute_dtype]

    def build_all_model(self):
        cfg = self.cfg
        self.segmentor = build_segmentor(cfg)
        module = self.segmentor.module
        module.init_weights(torch.Generator().manual_seed(cfg.train.random_seed))
        # backbone init before any resume, so a resume checkpoint wins
        if cfg.model.seg_model.pretrained:
            load_weights(cfg.model.seg_model.pretrained, module)
            self.logger.info(f"initialized from pretrained weights {cfg.model.seg_model.pretrained}")
        # weights-only init (the reference's cross-round resume): the round
        # trains its full schedule from step 0
        if cfg.train.init_from:
            load_weights(cfg.train.init_from, module)
            self.logger.info(f"initialized weights from {cfg.train.init_from}")
        resume = cfg.train.resume_from
        full = load_train_state(resume) if resume else None
        if resume and full is None:
            load_weights(resume, module)
            self.logger.info(f"resumed weights from {resume}")
        module.to(self.device)
        self.optimizer = make_optimizer(cfg, module)
        self.step = 0  # updates done
        if full is not None:
            module.load_state_dict(full["state_dict"])
            self.optimizer.load_state_dict(full["optimizer"])
            self.step = int(full["step"])
            self.logger.info(f"resumed the full train state from {resume} at step {self.step}")
        self.lr_fn = lr_schedule(cfg)
        self.model_recorder = ResultRecorder(cfg, "model", self.logger, self.writer, self.lr_fn)
        self.step_fn = self.make_step()

    def _workers(self):
        n = self.cfg.dataset.num_workers
        return n if n and n > 0 else None  # None: min(batch, cpu_count - 1)

    def build_train_data_reader(self):
        cfg = self.cfg
        if self.needs_target:
            ds = build_dataset(cfg, "target", pseudo_dir=cfg.dataset.target.pseudo_dir)
            self.t_dataset = ds
            self.t_stream = infinite_batches(
                ds, cfg.train.batch_size, seed=cfg.train.random_seed + 1, num_workers=self._workers()
            )

    def build_val_data_reader(self):
        cfg = self.cfg
        self.v_dataset = build_dataset(cfg, "val", aug_type=[]) if cfg.dataset.val.type else None
        self.val_step = None
        if self.v_dataset is not None and cfg.dataset.val.resize_size:
            self.val_step = make_val_step(
                self.segmentor, cfg.dataset.val.resize_size, cfg.dataset.num_classes, self.dtype
            )

    def _upload(self, batch: dict) -> dict:
        out = {}
        for key, arr in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(arr))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[key] = t
        return out

    # -- loop ----------------------------------------------------------------
    def _install_preemption_handler(self):
        """SIGTERM sets a flag: the loop checkpoints after the current
        iteration and stops (resumable via train.resume_from=<model_last.pth>)."""
        self._stop_requested = False

        def handler(signum, frame):
            self._stop_requested = True
            self.logger.warning(f"received signal {signum}: will checkpoint and stop after this iteration")

        try:
            self._prev_sigterm = signal.signal(signal.SIGTERM, handler)
        except ValueError:  # not the main thread
            self._prev_sigterm = None

    def _restore_preemption_handler(self):
        if getattr(self, "_prev_sigterm", None) is not None:
            signal.signal(signal.SIGTERM, self._prev_sigterm)

    def run(self):
        cfg = self.cfg
        self.logger.info("=" * 100)
        self.logger.info(f"config:\n{json.dumps(cfg.to_dict(), indent=1)}")
        self.logger.info("=" * 100)
        self.model_recorder.reset_time_and_losses()
        self.segmentor.module.train()
        self._install_preemption_handler()
        self.iter_times: list[float] = []  # host clock after each iteration's losses arrived
        self.loss_log: list[dict] = []
        try:
            start = self.step + 1
            batch = self._upload(self.next_batch()) if start <= cfg.train.total_iter else None
            for it in range(start, cfg.train.total_iter + 1):
                losses = self.step_fn(batch, it - 1)  # lr at the count of updates done
                self.step = it
                if it < cfg.train.total_iter:
                    batch = self._upload(self.next_batch())
                self.loss_log.append(self.model_recorder.record_losses(losses))
                self.iter_times.append(time.perf_counter())
                if it % cfg.train.iter_report == 0:
                    self.model_recorder.report_losses(it)
                if self.val_step is not None and it % cfg.train.iter_val == 0:
                    self.validate(it)
                if self._stop_requested:
                    self.save_checkpoint(it, is_best=False)
                    self.logger.warning(
                        f"preemption checkpoint saved at iter {it}; resume with "
                        f"train.resume_from={self.ckpt.path('model_last')}"
                    )
                    break
            else:
                # a final checkpoint off the validation cadence, so the last
                # iterations' weights reach model_last
                if self._last_ckpt_iter < cfg.train.total_iter:
                    self.save_checkpoint(cfg.train.total_iter, is_best=False)
        finally:
            self._restore_preemption_handler()
        self.model_recorder.report_end_info()

    def validate(self, iteration: int):
        module = self.segmentor.module
        module.eval()
        try:
            val_iter = BatchIterator(self.v_dataset, self.cfg.validate.batch_size, shuffle=False, drop_last=False)
            iou, miou = run_validation(self.val_step, prefetched(iter(val_iter), depth=2), self.device)
        finally:
            module.train()
        is_best = self.model_recorder.record_and_report_metrics(miou, iou, iteration)
        self.save_checkpoint(iteration, is_best)

    def checkpoint_state(self) -> dict:
        return {
            "state_dict": self.segmentor.module.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "step": self.step,
            "lr_schedule_step": self.step,  # the schedule is evaluated at the update count
        }

    _last_ckpt_iter = 0

    def save_checkpoint(self, iteration: int, is_best: bool):
        self.ckpt.save("model", self.checkpoint_state(), iteration, is_best)
        self._last_ckpt_iter = iteration


@TRAINER.register("SelfTrainingTrainer")
class SelfTrainingTrainer(BaseTrainer):
    """Target-only training on pseudo-labels (reference self_training_trainer.py)."""

    needs_target = True

    def assert_cfg(self):
        if not self.cfg.dataset.target.pseudo_dir:
            raise ValueError("dataset.target.pseudo_dir (--pseudo_save_dir) must be set for self-training")

    def make_step(self):
        return S.make_self_training_step(self.segmentor, self.optimizer, self.lr_fn, self.dtype)

    def next_batch(self):
        b = next(self.t_stream)
        return {"t_img": b["images"], "t_plbl": b["labels"]}  # uint8; cast on the device
