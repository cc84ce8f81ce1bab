"""Per-model loss and metric recording (reference code/utils/result_recorder.py).

The port of ``hiast_tpu/utils/recorder.py``.  Losses arrive as device
scalars; ``record_losses`` fetches the whole dict with one copy, which is
also the point where the host waits for the step.
"""
from __future__ import annotations

import time

import numpy as np
import torch


class ResultRecorder:
    def __init__(self, cfg, model_name: str = "model", logger=None, writer=None, lr_fn=None):
        self.cfg = cfg
        self.model_name = model_name
        self.logger = logger
        self.writer = writer
        self.lr_fn = lr_fn
        self.is_synthia = bool(cfg.dataset.source.type) and "SYNTHIA" in cfg.dataset.source.type
        self.best_miou = 0.0
        self.best_iter = 0
        self.miou_13_when_16_best = 0.0
        self.reset_time_and_losses()

    def reset_time_and_losses(self):
        self.losses_recorded = {"total_loss": 0.0}
        self._window_count = 0
        self.start_time = time.time()

    # -- losses --------------------------------------------------------------
    def record_losses(self, losses: dict) -> dict:
        """Adds one step's losses to the report window; returns them as floats."""
        values = torch.stack([v.detach().float().reshape(()) for v in losses.values()]).cpu().tolist()
        floats = dict(zip(losses.keys(), values))
        total = 0.0
        for name, v in floats.items():
            self.losses_recorded[name] = self.losses_recorded.get(name, 0.0) + v
            if "D_" not in name:
                total += v
        self.losses_recorded["total_loss"] += total
        self._window_count += 1
        return floats

    def report_losses(self, current_iter: int) -> None:
        n = max(self._window_count, 1)
        elapsed = time.time() - self.start_time
        s_per_iter = elapsed / n
        remain = (self.cfg.train.total_iter - current_iter) * s_per_iter
        means = {k: v / n for k, v in self.losses_recorded.items()}
        lr = float(self.lr_fn(current_iter)) if self.lr_fn else None
        imgs_per_s = self.cfg.train.batch_size / s_per_iter
        msg = (
            f"{self.model_name}, iter: {current_iter}/{self.cfg.train.total_iter}, "
            + ", ".join(f"{k}: {v:.4f}" for k, v in means.items())
            + (f", lr: {lr:.3e}" if lr is not None else "")
            + f", {s_per_iter:.3f} s/iter ({imgs_per_s:.1f} imgs/s), eta: {remain / 3600:.2f}h"
        )
        if self.logger:
            self.logger.info(msg)
        if self.writer:
            for k, v in means.items():
                self.writer.add_scalar(f"train_{self.model_name}/{k}", v, current_iter)
            if lr is not None:
                self.writer.add_scalar(f"train_{self.model_name}/lr", lr, current_iter)
            self.writer.add_scalar(f"train_{self.model_name}/imgs_per_s", imgs_per_s, current_iter)
        self.reset_time_and_losses()

    # -- metrics -------------------------------------------------------------
    def record_and_report_metrics(self, miou: float, iou: np.ndarray, current_iter: int) -> bool:
        """Returns True when this is a new best (after SYNTHIA rescaling)."""
        miou_13 = None
        if self.is_synthia:
            miou = miou * 19 / 16
            iou13 = np.asarray(iou).copy()
            iou13[3:6] = 0
            miou_13 = float(np.mean(iou13) * 19 / 13)

        is_best = miou > self.best_miou
        if is_best:
            self.best_miou = miou
            self.best_iter = current_iter
            if miou_13 is not None:
                self.miou_13_when_16_best = miou_13

        per_class = {i: round(float(v), 3) for i, v in enumerate(iou)}
        if self.is_synthia:
            msg = (
                f"{self.model_name}, iter: {current_iter}, miou_16: {miou:.4f}"
                f"({self.best_miou:.4f}), miou_13: {miou_13:.4f}, iou: {per_class}"
            )
        else:
            msg = (
                f"{self.model_name}, iter: {current_iter}, miou: {miou:.4f}"
                f"({self.best_miou:.4f}), iou: {per_class}"
            )
        if self.logger:
            self.logger.info(msg)
        if self.writer:
            tag = "miou_16" if self.is_synthia else "miou"
            self.writer.add_scalar(f"val_{self.model_name}/{tag}", miou, current_iter)
            if miou_13 is not None:
                self.writer.add_scalar(f"val_{self.model_name}/miou_13", miou_13, current_iter)
            for i, v in enumerate(iou):
                self.writer.add_scalar(f"val_{self.model_name}/iou_{i}", float(v), current_iter)
        return is_best

    def report_end_info(self) -> None:
        if self.logger:
            extra = f", miou_13: {self.miou_13_when_16_best:.4f}" if self.is_synthia else ""
            self.logger.info(
                f"{self.model_name}: best miou {self.best_miou:.4f} at iter {self.best_iter}{extra}"
            )
