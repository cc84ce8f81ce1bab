"""Host-side datasets: manifest-driven decode + remap + geometric aug.

The part of ``hiast_tpu/data/datasets.py`` that pseudo-label generation and
validation use: the Cityscapes target set with the deterministic 'PRS-h-w'
resize, and the val split at its native size with its labels (no augs).
Samples leave the host as uint8 [H, W, 3] images and uint8 [H, W] labels,
batched by ``data/pipeline.py`` exactly as in the JAX package.  PNGs decode
through the port's numpy codec (``data/png.py``); PIL is imported only for
files that codec does not read.
"""
from __future__ import annotations

import json
import os
from typing import Callable

import numpy as np

from hiast_tpu_torch.data import augment as A
from hiast_tpu_torch.data.png import decode_png_file
from hiast_tpu_torch.data.remap import remap_label
from hiast_tpu_torch.registry import DATASET

IGNORE = 255


def _pil_read(path: str, mode: str | None) -> np.ndarray:
    from PIL import Image

    img = Image.open(path)
    return np.asarray(img.convert(mode) if mode else img, np.uint8)


def read_rgb(path: str) -> np.ndarray:
    arr = decode_png_file(path)
    if arr is not None:
        if arr.ndim == 3 and arr.shape[2] == 3:
            return arr
        if arr.ndim == 3 and arr.shape[2] == 4:
            return np.ascontiguousarray(arr[..., :3])
        if arr.ndim == 2:
            return np.repeat(arr[..., None], 3, axis=2)
    return _pil_read(path, "RGB")


def read_gray(path: str) -> np.ndarray:
    arr = decode_png_file(path)
    if arr is not None and arr.ndim == 2:
        return arr
    return _pil_read(path, None)


def get_path_list(json_path: str, image_dir: str):
    """JSON manifest -> absolute (image, label) path lists (reference
    datasets/utils.py:21-34)."""
    with open(json_path) as f:
        data = json.load(f)
    imgs = [os.path.join(image_dir, d["image_name"]) for d in data]
    lbls = [os.path.join(image_dir, d["mask_name"]) for d in data]
    return imgs, lbls


class BaseDataset:
    def __init__(
        self,
        cfg,
        json_path: str,
        image_dir: str,
        aug_type=(),
        num_classes: int = 19,
    ):
        self.cfg = cfg
        self.num_classes = num_classes
        host_augs, color_aug = A.split_aug_types(list(aug_type))
        if color_aug is not None:
            raise NotImplementedError(
                f"device color aug {color_aug!r} is ROADMAP.md item A5: not ported yet"
            )
        self.aug_fns = [self.build_aug_fn(a) for a in host_augs]
        self.aug_fns = [a for a in self.aug_fns if a is not None]
        self.img_paths, self.lbl_paths = get_path_list(json_path, image_dir)

    # -- per-dataset hooks ---------------------------------------------------
    def read_label(self, path: str) -> np.ndarray | None:
        raise NotImplementedError

    def build_aug_fn(self, aug_type: str | None) -> Callable | None:
        raise NotImplementedError

    # -- core ---------------------------------------------------------------
    def __len__(self):
        return len(self.img_paths)

    def load_data(self, index: int):
        """-> (img uint8 [H,W,3], lbl uint8 [H,W], img_path)."""
        img_path = self.img_paths[index]
        img = read_rgb(img_path)
        lbl = self.read_label(self.lbl_paths[index])
        if lbl is None:
            lbl = np.full(img.shape[:2], IGNORE, np.uint8)
        if lbl.shape != img.shape[:2]:
            lbl = A.resize_nearest(lbl, img.shape[0], img.shape[1])
        return img, lbl, img_path

    def get_item(self, index: int, rng: np.random.Generator) -> dict:
        """One sample: load + host geometric augs.

        An unreadable file is reported and the neighbouring index is loaded
        instead, as the JAX package does (reference base_dataset.py:81-86)."""
        try:
            img, lbl, img_path = self.load_data(index)
        except Exception as e:  # noqa: BLE001 - deliberate robustness net
            print(f"## {e!r} loading index {index}: {self.img_paths[index]}")
            index = index - 1 if index > 0 else index + 1
            return self.get_item(index, rng)
        for fn in self.aug_fns:
            img, lbl = fn(img, lbl, rng)
        return {
            "images": np.ascontiguousarray(img),
            "labels": np.ascontiguousarray(lbl),
            "image_paths": img_path,
        }


@DATASET.register("Cityscapes")
class CityscapesDataset(BaseDataset):
    def read_label(self, path):
        if self.num_classes not in (9, 19):
            raise ValueError(f"Cityscapes has 19 or 9 classes, not {self.num_classes}")
        lbl = read_gray(path)
        if self.num_classes == 9:  # Cityscapes -> Oxford scenario
            lbl = remap_label(lbl, "Cityscapes9")
        return lbl

    def build_aug_fn(self, aug_type):
        if not aug_type:
            return None
        if aug_type.startswith("PRS"):
            return A.Resize(*A.parse_resize_params(aug_type))
        raise NotImplementedError(
            f"aug_type {aug_type!r} is a training aug, ROADMAP.md item A5: not ported yet"
        )


def build_dataset(cfg, section, aug_type=None, num_classes=None):
    """Instantiate the dataset named by a cfg.dataset.<section> block.
    (Reading pseudo-labels back, ``pseudo_dir``, comes with the training
    slice.)"""
    node = getattr(cfg.dataset, section)
    return DATASET[node.type](
        cfg,
        node.json_path,
        node.image_dir,
        aug_type=aug_type if aug_type is not None else list(getattr(node, "aug_type", [])),
        num_classes=num_classes or cfg.dataset.num_classes,
    )
