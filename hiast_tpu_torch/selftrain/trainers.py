"""Training workflows (TRAINER registry).

The port of ``hiast_tpu/selftrain/trainers.py`` (reference:
code/workflows/trainer/*.py): ``BaseTrainer`` assembles model, optimizer,
data streams, recorder and checkpoint policy; the warmup trainers train on
a labelled source, ``SourceOnlyTrainer`` alone and
``AdversarialWarmupTrainer`` against a domain discriminator on the target;
``SelfTrainingTrainer`` trains on the previous round's pseudo-labels;
``ConsistencySelfTrainingTrainer`` is the HIAST trainer (EMA teacher,
strong view on the card, hard-aware copy-paste, the directional-consistency
loss); ``MutualLearningTrainer`` trains two students that teach each other.

One process a GPU under ``torchrun`` (``parallel/mesh.py``): the build
checks ``runtime.mesh`` against the world size (``check_mesh``), each rank
draws a local batch of ``batch_size / N`` from its own stream
(``stream_seed``), BatchNorm becomes the synced one above one rank
(``models/norm.py``), and rank 0's weights and buffers (the EMA teacher,
the peer and the discriminator included) go to every rank once, after any
resume.  The steps sum gradients and losses over the ranks
(``selftrain/steps.py``); validation runs on each rank's share.  Rank 0
alone writes the config, the log file, the tensorboard events and the
checkpoints, and the others wait for its saves.  Without a process group
this is one process on one device.

The loop keeps the JAX trainer's one-batch-deep pipeline: it enqueues step
k on the card, then assembles and uploads batch k+1 (from pinned memory, so
the copy does not wait for the step) while the card works, then fetches
step k's losses.
"""
from __future__ import annotations

import copy
import json
import os
import signal
import time

import numpy as np
import torch

from hiast_tpu_torch.data.augment import split_aug_types
from hiast_tpu_torch.data.datasets import build_dataset
from hiast_tpu_torch.data.native_ops import host_ops_for
from hiast_tpu_torch.data.pipeline import BatchIterator, infinite_batches, prefetched
from hiast_tpu_torch.evaluation import make_val_step, run_validation
from hiast_tpu_torch.models.norm import convert_synced
from hiast_tpu_torch.models.segmentors import build_segmentor
from hiast_tpu_torch.parallel import mesh
from hiast_tpu_torch.registry import PREPROCESSOR, TRAINER
from hiast_tpu_torch.selftrain import steps as S
from hiast_tpu_torch.selftrain.train_state import (
    lr_schedule,
    lr_schedule_for_d,
    make_d_optimizer,
    make_optimizer,
)
from hiast_tpu_torch.utils.checkpoint import (
    CheckpointPolicy,
    load_train_state,
    load_weights,
    save_train_state,
)
from hiast_tpu_torch.utils.logging_utils import init_logger, init_writer
from hiast_tpu_torch.utils.recorder import ResultRecorder

COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class BaseTrainer:
    """Common assembly: model, optimizer, data, recorder, checkpoint policy.
    The source stream draws from seed ``random_seed``, the target stream
    from ``random_seed + 1``, each plus 7919 a rank (the JAX
    ``_stream_seed``)."""

    needs_source = False
    needs_target = False

    def __init__(self, cfg, device: torch.device | str = "cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.host = host_ops_for(self.device.type)  # the data path's pixel work: C++ beside a card
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
        mesh.check_mesh(cfg, cfg.train.batch_size)
        self.local_batch = cfg.train.batch_size // mesh.world_size()
        np.random.seed(cfg.train.random_seed)
        torch.manual_seed(cfg.train.random_seed)
        os.makedirs(cfg.work_dir, exist_ok=True)
        if mesh.is_main():
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
        convert_synced(module)
        module.to(self.device)
        self.optimizer = make_optimizer(cfg, module)
        self.count = S.StepCount()
        if full is not None:
            module.load_state_dict(full["state_dict"])
            self.optimizer.load_state_dict(full["optimizer"])
            self.count = S.StepCount(int(full["step"]), int(full.get("lr_schedule_step", full["step"])))
            self.logger.info(f"resumed the full train state from {resume} at step {self.step}")
        self.build_extra_state(full)
        for m in self.replicated_modules():
            mesh.broadcast_module(m)
        self.lr_fn = lr_schedule(cfg)
        self.model_recorder = ResultRecorder(cfg, "model", self.logger, self.writer, self.lr_fn)
        self.step_fn = self.make_step()

    @property
    def step(self) -> int:
        """Steps taken."""
        return self.count.iterations

    def build_extra_state(self, full: dict | None) -> None:
        """Hook: state beyond the student and its optimizer, built after the
        student's weights are final (``full``: the resumed state, or None)."""

    def replicated_modules(self) -> list:
        """Every module whose weights the ranks must share."""
        return [self.segmentor.module]

    def _workers(self):
        """``dataset.num_workers``; on auto (None) at one rank
        ``infinite_batches`` takes min(batch, cpu_count - 1), and the ranks
        of one host split those threads."""
        n = self.cfg.dataset.num_workers
        if n and n > 0:
            return n
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", mesh.world_size()))
        if local_world <= 1:
            return None
        return min(self.local_batch, max((os.cpu_count() or 1) - 1, 0) // local_world)

    def _stream(self, ds, offset: int):
        return infinite_batches(ds, self.local_batch, seed=mesh.stream_seed(self.cfg.train.random_seed, offset),
                                num_workers=self._workers())

    def build_train_data_reader(self):
        cfg = self.cfg
        if self.needs_source:
            ds = build_dataset(cfg, "source", host=self.host)
            self.s_dataset = ds
            self.s_stream = self._stream(ds, 0)
        if self.needs_target:
            ds = build_dataset(cfg, "target", pseudo_dir=cfg.dataset.target.pseudo_dir, host=self.host)
            self.t_dataset = ds
            self.t_stream = self._stream(ds, 1)

    def build_val_data_reader(self):
        cfg = self.cfg
        self.v_dataset = (
            build_dataset(cfg, "val", aug_type=[], host=self.host) if cfg.dataset.val.type else None
        )
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
                losses = self.step_fn(batch, self.count)  # advances the count to it
                if it < cfg.train.total_iter:
                    batch = self._upload(self.next_batch())
                self.loss_log.append(self.model_recorder.record_losses(losses))
                self.iter_times.append(time.perf_counter())
                if it % cfg.train.iter_report == 0:
                    self.model_recorder.report_losses(it)
                if self.val_step is not None and it % cfg.train.iter_val == 0:
                    self.validate(it)
                if mesh.any_rank(self._stop_requested, self.device):  # every rank stops at one iteration
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

    def _run_validation(self, val_step, module) -> tuple:
        """(iou, miou) of ``val_step`` over the val set, ``module`` in eval mode."""
        was_training = module.training
        module.eval()
        try:
            val_iter = BatchIterator(self.v_dataset, self.cfg.validate.batch_size, shuffle=False, drop_last=False,
                                     share=mesh.share())
            return run_validation(val_step, prefetched(iter(val_iter), depth=2), self.device,
                                  target=val_iter.local_size)
        finally:
            module.train(was_training)

    def validate(self, iteration: int):
        iou, miou = self._run_validation(self.val_step, self.segmentor.module)
        is_best = self.model_recorder.record_and_report_metrics(miou, iou, iteration)
        self.save_checkpoint(iteration, is_best)

    def checkpoint_state(self) -> dict:
        return {
            "state_dict": self.segmentor.module.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "step": self.count.iterations,
            "lr_schedule_step": self.count.updates,  # the schedule is evaluated at the update count
        }

    _last_ckpt_iter = 0

    def save_checkpoint(self, iteration: int, is_best: bool):
        """Rank 0 writes (``write_checkpoints``); the other ranks wait."""
        if mesh.is_main():
            self.write_checkpoints(iteration, is_best)
        mesh.barrier()
        self._last_ckpt_iter = iteration

    def write_checkpoints(self, iteration: int, is_best: bool):
        self.ckpt.save("model", self.checkpoint_state(), iteration, is_best)


@TRAINER.register("SourceOnlyTrainer")
class SourceOnlyTrainer(BaseTrainer):
    """Supervised warmup on the labelled source (reference source_only_trainer.py)."""

    needs_source = True

    def make_step(self):
        return S.make_source_only_step(self.segmentor, self.optimizer, self.lr_fn, self.dtype)

    def next_batch(self):
        b = next(self.s_stream)
        return {"s_img": b["images"], "s_lbl": b["labels"]}  # uint8; cast on the device


@TRAINER.register("AdversarialWarmupTrainer")
class AdversarialWarmupTrainer(BaseTrainer):
    """Adversarial warmup (reference adversarial_warmup_trainer.py; JAX
    ``trainers.py:582-608``): the source's segmentation loss, and the
    target aligned to it through ``AdversarialWarmupSegmentor``'s
    discriminator, which trains beside the trunk with its own Adam.

    The discriminator is initialised from ``random_seed + 7`` once the
    trunk's weights are final.  The full-state ``model_last.pth`` carries
    its state_dict (``discriminator``), its optimizer (``d_optimizer``) and
    its schedule count (``d_lr_schedule_step``) beside the trunk's, and
    ``train.resume_from`` restores all three; ``load_weights`` of the file
    still reads the trunk alone, so the round driver takes it as
    ``--warmup_ckpt`` and ``--warmup_pseudo_ckpt``."""

    needs_source = True
    needs_target = True

    def assert_cfg(self):
        if not self.cfg.model.discriminator.is_enabled:
            raise ValueError("AdversarialWarmupTrainer needs model.discriminator.is_enabled True")

    def build_extra_state(self, full):
        cfg = self.cfg
        discriminator = self.segmentor.discriminator
        discriminator.init_weights(torch.Generator().manual_seed(cfg.train.random_seed + 7))
        discriminator.to(self.device)
        self.d_optimizer = make_d_optimizer(cfg, discriminator)
        self.d_lr_fn = lr_schedule_for_d(cfg)
        if full is None:
            return
        if "discriminator" not in full:
            raise ValueError(
                f"{cfg.train.resume_from}: a full train state without a discriminator; start "
                "from its weights with train.init_from instead"
            )
        if int(full["d_lr_schedule_step"]) != self.count.updates:
            raise ValueError(
                f"{cfg.train.resume_from}: discriminator schedule at {full['d_lr_schedule_step']}, "
                f"the trunk's at {self.count.updates}"
            )
        discriminator.load_state_dict(full["discriminator"])
        self.d_optimizer.load_state_dict(full["d_optimizer"])
        self.logger.info(f"resumed the discriminator from {cfg.train.resume_from}")

    def replicated_modules(self):
        return super().replicated_modules() + [self.segmentor.discriminator]

    def make_step(self):
        return S.make_adversarial_step(
            self.segmentor, self.optimizer, self.lr_fn, self.d_optimizer, self.d_lr_fn, self.dtype
        )

    def next_batch(self):
        s = next(self.s_stream)
        t = next(self.t_stream)
        return {"s_img": s["images"], "s_lbl": s["labels"], "t_img": t["images"]}  # uint8

    def checkpoint_state(self) -> dict:
        state = super().checkpoint_state()
        state["discriminator"] = self.segmentor.discriminator.state_dict()
        state["d_optimizer"] = self.d_optimizer.state_dict()
        state["d_lr_schedule_step"] = self.count.updates
        return state


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


@TRAINER.register("ConsistencySelfTrainingTrainer")
class ConsistencySelfTrainingTrainer(SelfTrainingTrainer):
    """The HIAST trainer (reference consistency_self_training_trainer.py; JAX
    ``trainers.py:396-514``): an EMA teacher, the strong view made on the
    card ('CCA' or 'SCA' from ``dataset.target.aug_type``), and hard-aware
    copy-paste over the previous round's statistics.

    The teacher is a second module, a copy of the student once the
    student's weights are loaded (``pretrained``, ``init_from``, a
    weights-only resume), and a full-state resume restores its parameters.
    Every save writes ``ema_model_last.pth`` beside the student's
    checkpoints (the final and preemption saves included): the teacher's
    parameters with the student's buffers, in the reference ``.pth``
    layout, which the generation CLI reads with ``--pseudo_resume_from``."""

    def assert_cfg(self):
        super().assert_cfg()
        cfg = self.cfg
        if not cfg.cst_training.is_enabled:
            raise ValueError("ConsistencySelfTrainingTrainer needs cst_training.is_enabled True")
        # a falsy type is plain consistency self-training (no copy-paste), as in the JAX package
        if cfg.preprocessor.type and cfg.preprocessor.type not in PREPROCESSOR:
            raise KeyError(f"unknown preprocessor.type {cfg.preprocessor.type!r} (known: {sorted(PREPROCESSOR)})")

    def build_extra_state(self, full):
        self.ema_module = copy.deepcopy(self.segmentor.module).requires_grad_(False).eval()
        self.ema_segmentor = self.segmentor.with_module(self.ema_module)
        if full is not None and "ema" in full:
            ema_params = dict(self.ema_module.named_parameters())
            if sorted(full["ema"]) != sorted(ema_params):
                raise ValueError(f"{self.cfg.train.resume_from}: its EMA parameters do not match the model")
            with torch.no_grad():
                for name, p in ema_params.items():
                    p.copy_(full["ema"][name])
            self.logger.info(f"resumed the EMA teacher from {self.cfg.train.resume_from}")

    def replicated_modules(self):
        return super().replicated_modules() + [self.ema_module]

    def build_all_model(self):
        super().build_all_model()
        self.ema_recorder = ResultRecorder(self.cfg, "ema_model", self.logger, self.writer, self.lr_fn)

    def build_train_data_reader(self):
        cfg = self.cfg
        pseudo_dir = cfg.dataset.target.pseudo_dir
        ds = build_dataset(cfg, "target", pseudo_dir=pseudo_dir, host=self.host)
        kind = cfg.preprocessor.type
        if kind == "CopyPaste" and not ds.get_samples_with_class():
            # the reference fails here too (base_dataset.py:61-77, consistency trainer :27-44)
            raise FileNotFoundError(
                "preprocessor.type CopyPaste needs the samples_with_class stats: expected "
                f"samples_with_class.json next to pseudo_dir={pseudo_dir!r} (written by the "
                "pseudo-label generation round); point dataset.target.pseudo_dir at a generated "
                "round, or set preprocessor.type to None for plain consistency self-training"
            )
        cmp_path = os.path.join(os.path.dirname(os.path.normpath(pseudo_dir)), "class_mean_probabilities.npy")
        if os.path.exists(cmp_path):
            class_value = np.load(cmp_path)
        else:
            if kind == "CopyPaste":
                self.logger.warning(
                    f"class_mean_probabilities.npy not found next to pseudo_dir={pseudo_dir!r}: HPA's "
                    "hard-class weighting falls back to uniform (class_value 0.9); the reference "
                    "requires this file (consistency trainer :29-30)"
                )
            class_value = np.full(cfg.dataset.num_classes, 0.9, np.float32)
        if kind:
            ds.set_preprocessor(PREPROCESSOR[kind](cfg, ds, class_value))
        self.t_dataset = ds
        self.paste_shares: list[float] = []  # share of pasted pixels per batch
        self.t_stream = self._stream(ds, 1)

    def next_batch(self):
        b = next(self.t_stream)
        out = {"t_img": b["images"], "t_plbl": b["labels"]}  # uint8; cast on the device
        if "copy_paste_mask" in b:
            self.paste_shares.append(np.count_nonzero(b["copy_paste_mask"] != 255) / b["copy_paste_mask"].size)
            if self.cfg.cst_training.dcst_loss.weight > 0:  # on the crop's grid (the dataset replays the augs)
                out["copy_paste_mask"] = b["copy_paste_mask"]
        return out

    def make_step(self):
        _, strong = split_aug_types(list(self.cfg.dataset.target.aug_type))
        generator = torch.Generator(self.device).manual_seed(self.cfg.train.random_seed)
        return S.make_consistency_step(
            self.segmentor, self.ema_module, self.optimizer, self.lr_fn, self.dtype,
            strong_aug=strong, generator=generator,
        )

    def sync_ema_buffers(self) -> None:
        """The student's BatchNorm buffers into the teacher."""
        torch._foreach_copy_(list(self.ema_module.buffers()), list(self.segmentor.module.buffers()))

    def build_val_data_reader(self):
        super().build_val_data_reader()
        self.ema_val_step = None
        if self.val_step is not None:
            self.ema_val_step = make_val_step(
                self.ema_segmentor, self.cfg.dataset.val.resize_size, self.cfg.dataset.num_classes, self.dtype
            )

    def validate(self, iteration: int):
        super().validate(iteration)  # the student, and the checkpoints
        self.sync_ema_buffers()
        iou, miou = self._run_validation(self.ema_val_step, self.ema_module)
        self.ema_recorder.record_and_report_metrics(miou, iou, iteration)

    def checkpoint_state(self) -> dict:
        state = super().checkpoint_state()
        state["ema"] = {name: p.detach() for name, p in self.ema_module.named_parameters()}
        return state

    def write_checkpoints(self, iteration: int, is_best: bool):
        super().write_checkpoints(iteration, is_best)
        self.sync_ema_buffers()
        save_train_state(self.ckpt.path("ema_model_last"), self.ema_module.state_dict())

    def run(self):
        super().run()
        self.ema_recorder.report_end_info()


@TRAINER.register("MutualLearningTrainer")
class MutualLearningTrainer(SelfTrainingTrainer):
    """Two students co-train on the pseudo-labels, each matching the other's
    target (JAX ``trainers.py:517-580``; the reference's latent
    ``mut_training``, code/utils/default_config.py:159-167).

    The peer is a second module of the student's layout, initialised from
    ``random_seed + 13``, then loaded from ``mut_training.resume_from``
    where set, with its own optimizer.  The full-state ``model_last.pth``
    carries its state_dict (``peer_state_dict``) and its optimizer
    (``peer_optimizer``) beside the student's, and ``train.resume_from``
    restores both.  Every validation validates the peer too
    (``peer_model``).  Like the JAX trainer it writes no teacher
    checkpoint, so the round driver runs it for one round."""

    def assert_cfg(self):
        super().assert_cfg()
        mut = self.cfg.mut_training
        if not mut.is_enabled or not mut.mut_loss.weight > 0:
            raise ValueError("MutualLearningTrainer needs mut_training.is_enabled True and a "
                             "mut_training.mut_loss.weight above 0")

    def build_extra_state(self, full):
        cfg = self.cfg
        self.peer_module = build_segmentor(cfg).module
        self.peer_module.init_weights(torch.Generator().manual_seed(cfg.train.random_seed + 13))
        if cfg.mut_training.resume_from:
            load_weights(cfg.mut_training.resume_from, self.peer_module)
            self.logger.info(f"peer initialized from {cfg.mut_training.resume_from}")
        convert_synced(self.peer_module)
        self.peer_module.to(self.device)
        self.peer_segmentor = self.segmentor.with_module(self.peer_module)
        self.peer_optimizer = make_optimizer(cfg, self.peer_module)
        if full is None:
            return
        if "peer_state_dict" not in full:
            raise ValueError(
                f"{cfg.train.resume_from}: a full train state without the peer; start from its "
                "weights with train.init_from instead"
            )
        self.peer_module.load_state_dict(full["peer_state_dict"])
        self.peer_optimizer.load_state_dict(full["peer_optimizer"])
        self.logger.info(f"resumed the peer from {cfg.train.resume_from}")

    def replicated_modules(self):
        return super().replicated_modules() + [self.peer_module]

    def build_all_model(self):
        super().build_all_model()
        self.peer_recorder = ResultRecorder(self.cfg, "peer_model", self.logger, self.writer, self.lr_fn)

    def make_step(self):
        _, strong = split_aug_types(list(self.cfg.dataset.target.aug_type))
        generator = torch.Generator(self.device).manual_seed(self.cfg.train.random_seed)
        return S.make_mutual_step(
            self.segmentor, self.peer_module, self.optimizer, self.peer_optimizer, self.lr_fn, self.dtype,
            strong_aug=strong, generator=generator,
        )

    def build_val_data_reader(self):
        super().build_val_data_reader()
        self.peer_val_step = None
        if self.val_step is not None:
            self.peer_val_step = make_val_step(
                self.peer_segmentor, self.cfg.dataset.val.resize_size, self.cfg.dataset.num_classes, self.dtype
            )

    def validate(self, iteration: int):
        super().validate(iteration)  # the student, and the checkpoints
        iou, miou = self._run_validation(self.peer_val_step, self.peer_module)
        self.peer_recorder.record_and_report_metrics(miou, iou, iteration)

    def checkpoint_state(self) -> dict:
        state = super().checkpoint_state()
        state["peer_state_dict"] = self.peer_module.state_dict()
        state["peer_optimizer"] = self.peer_optimizer.state_dict()
        return state

    def run(self):
        super().run()
        self.peer_recorder.report_end_info()
