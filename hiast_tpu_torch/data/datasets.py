"""Host-side datasets: manifest-driven decode + remap + geometric aug.

The port of ``hiast_tpu/data/datasets.py``: the GTA5 and SYNTHIA source
sets, the Cityscapes set (target, val, or the source of the Oxford
scenario with its 19 -> 9 remap) and the Oxford RobotCar set, each with
the JAX package's per-dataset aug vocabulary: the deterministic 'PRS-h-w'
resize, the 'MS' / 'OMS' random-sized crops, 'DACS' and 'FDA-*'.  A target
set is read with the previous round's pseudo-labels (``pseudo_dir``) for
self-training, and the val split at its native size with its labels (no
augs).  Label files, per dataset (JAX ``datasets.py:189-335``):

- GTAV: palette PNGs in GTA5 label ids, read as their indices, remapped;
- SYNTHIA: channel 0 of a 16-bit RGB PNG, clipped to 255, remapped;
- Cityscapes: train ids, remapped to 9 classes when the run has 9;
- Oxford: channel 0, remapped; a label path not ending in ``.png`` is the
  unlabelled train split (all 255).  A 16-bit file gives what the JAX
  reader's PIL fallback gives: a gray value's low byte, an RGB(A) or
  gray+alpha file's first sample's high byte.
With a ``pseudo_dir`` the dataset also loads that round's
``samples_with_class.json`` (the donor lists copy-paste draws from), and a
preprocessor (``set_preprocessor``: HPA's ``CopyPaste``, ``ClassMix`` or
``CutMix``) runs on each sample before the geometric augs.  A device colour
aug in ``aug_type`` ('CCA', 'SCA') is left to the train step.
Samples leave the host as uint8 [H, W, 3] images and uint8 [H, W] labels,
batched by ``data/pipeline.py`` exactly as in the JAX package.  PNGs decode
through the port's codec (``data/png.py``) with the row unfilter the caller
names for its device (``unfilter``); PIL is imported only for files that
are not PNGs.
"""
from __future__ import annotations

import json
import os
from typing import Callable

import numpy as np

from hiast_tpu_torch.data import augment as A
from hiast_tpu_torch.data.png import Unfilter, decode_png_file, unfilter_plain
from hiast_tpu_torch.data.remap import remap_label
from hiast_tpu_torch.registry import DATASET

IGNORE = 255


def _pil_read(path: str, mode: str | None) -> np.ndarray:
    from PIL import Image

    img = Image.open(path)
    return np.asarray(img.convert(mode) if mode else img, np.uint8)


def read_rgb(path: str, unfilter: Unfilter = unfilter_plain) -> np.ndarray:
    """uint8 [H, W, 3]: gray repeated, alpha dropped, 16 bits cut to their
    high byte."""
    arr = decode_png_file(path, unfilter)
    if arr is None:
        return _pil_read(path, "RGB")
    if arr.dtype == np.uint16:
        arr = (arr >> 8).astype(np.uint8)
    if arr.ndim == 2 or arr.shape[2] == 2:
        return np.repeat(arr.reshape(arr.shape[0], arr.shape[1], -1)[..., :1], 3, axis=2)
    return np.ascontiguousarray(arr[..., :3])


def read_gray(path: str, unfilter: Unfilter = unfilter_plain) -> np.ndarray:
    """A label map as PIL's ``np.asarray(Image.open(path), np.uint8)`` gives
    it (the JAX package's reader): a palette image's indices, 16-bit values
    cast to uint8."""
    arr = decode_png_file(path, unfilter, palette=False)
    if arr is None:
        return _pil_read(path, None)
    return arr.astype(np.uint8, copy=False)


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
        pseudo_dir: str | None = None,
        aug_type=(),
        num_classes: int = 19,
        *,
        unfilter: Unfilter,
    ):
        self.cfg = cfg
        self.pseudo_dir = pseudo_dir
        self.num_classes = num_classes
        self.unfilter = unfilter
        self.preprocessor = None
        host_augs, _ = A.split_aug_types(list(aug_type))  # a colour aug is the train step's
        self.aug_fns = [self.build_aug_fn(a) for a in host_augs]
        self.aug_fns = [a for a in self.aug_fns if a is not None]
        self.img_paths, self.lbl_paths = get_path_list(json_path, image_dir)
        self.file_to_idx = {os.path.basename(p): i for i, p in enumerate(self.img_paths)}

        # class -> donor image list, for copy-paste (reference
        # base_dataset.py:61-77: sort by pixel count, drop the smallest 10%)
        self.samples_with_class: dict[int, list[str]] | None = None
        if self.pseudo_dir is not None:
            stats_dir = os.path.dirname(os.path.normpath(self.pseudo_dir))
            swc_path = os.path.join(stats_dir, "samples_with_class.json")
            if os.path.exists(swc_path):
                with open(swc_path) as f:
                    raw = {int(k): v for k, v in json.load(f).items()}
                self.samples_with_class = {}
                for c in range(num_classes):
                    entries = sorted(raw.get(c, []), key=lambda e: e[1])
                    files = [os.path.basename(e[0]) for e in entries]
                    self.samples_with_class[c] = files[round(len(files) * 0.1):]

    # -- per-dataset hooks ---------------------------------------------------
    def read_label(self, path: str) -> np.ndarray | None:
        raise NotImplementedError

    def build_aug_fn(self, aug_type: str | None) -> Callable | None:
        raise NotImplementedError

    def fda(self, section: str) -> A.FDA:
        """'FDA-Source' / 'FDA-Target': amplitudes from the images of
        ``cfg.dataset.<section>``, decoded as this dataset decodes."""
        node = getattr(self.cfg.dataset, section)
        return A.FDA(node.json_path, node.image_dir, lambda path: read_rgb(path, self.unfilter))

    # -- core ---------------------------------------------------------------
    def __len__(self):
        return len(self.img_paths)

    def set_preprocessor(self, preprocessor):
        self.preprocessor = preprocessor

    def get_samples_with_class(self):
        return self.samples_with_class

    def get_file_to_idx(self, file_name: str) -> int:
        return self.file_to_idx[file_name]

    def load_data(self, index: int):
        """-> (img uint8 [H,W,3], lbl uint8 [H,W], img_path).  With a
        ``pseudo_dir`` the label is ``<pseudo_dir>/<name>_pseudo_label.png``,
        resized (nearest) to the image when the sizes differ."""
        img_path = self.img_paths[index]
        img = read_rgb(img_path, self.unfilter)
        if self.pseudo_dir is not None:
            name = os.path.splitext(os.path.basename(img_path))[0]
            lbl = read_gray(os.path.join(self.pseudo_dir, f"{name}_pseudo_label.png"), self.unfilter)
        else:
            lbl = self.read_label(self.lbl_paths[index])
        if lbl is None:
            lbl = np.full(img.shape[:2], IGNORE, np.uint8)
        if lbl.shape != img.shape[:2]:
            lbl = A.resize_nearest(lbl, img.shape[0], img.shape[1])
        return img, lbl, img_path

    def get_item(self, index: int, rng: np.random.Generator) -> dict:
        """One sample: load, the preprocessor (copy-paste) when one is set,
        then the host geometric augs, all drawing from ``rng`` in the JAX
        package's order.  With a preprocessor the sample also carries its
        ``copy_paste_mask`` (the pasted donor labels, 255 elsewhere): on
        the image's grid before the augs, or, with
        ``cst_training.dcst_loss.weight`` > 0, on the augmented grid.  Then
        the augs are replayed with the mask in the label's place on a fresh
        generator that carries ``rng``'s state from before them (the same
        crops and flips); the replay's image is discarded and ``rng``
        advances as it does without the replay.

        An unreadable file is reported and the neighbouring index is loaded
        instead, as the JAX package does (reference base_dataset.py:81-86)."""
        try:
            img, lbl, img_path = self.load_data(index)
        except Exception as e:  # noqa: BLE001 - deliberate robustness net
            print(f"## {e!r} loading index {index}: {self.img_paths[index]}")
            index = index - 1 if index > 0 else index + 1
            return self.get_item(index, rng)
        result = {}
        replay = None
        if self.preprocessor is not None:
            img, lbl, cp_mask = self.preprocessor.run(img, lbl, rng)
            result["copy_paste_mask"] = cp_mask
            if self.cfg.cst_training.dcst_loss.weight > 0:
                replay = np.random.default_rng()
                replay.bit_generator.state = rng.bit_generator.state
                img_pre = img
        for fn in self.aug_fns:
            img, lbl = fn(img, lbl, rng)
        if replay is not None:
            for fn in self.aug_fns:
                img_pre, cp_mask = fn(img_pre, cp_mask, replay)
            result["copy_paste_mask"] = cp_mask
        result["images"] = np.ascontiguousarray(img)
        result["labels"] = np.ascontiguousarray(lbl)
        result["image_paths"] = img_path
        return result


@DATASET.register("GTAV")
class GTAVDataset(BaseDataset):
    def read_label(self, path):
        return remap_label(read_gray(path, self.unfilter), "GTAV")

    def build_aug_fn(self, aug_type):
        if not aug_type:
            return None
        if aug_type == "MS":
            ch, cw = self.cfg.dataset.crop_size
            return A.GeometricAug(ch, cw, (341, 950), w2h_ratio=2)
        if aug_type == "DACS":
            return A.ResizeCrop(720, 1280, 512, 512)
        if aug_type.startswith("PRS"):
            return A.Resize(*A.parse_resize_params(aug_type))
        if aug_type == "FDA-Target":
            return self.fda("target")
        raise ValueError(f"invalid aug_type {aug_type!r}")


@DATASET.register("SYNTHIA")
class SYNTHIADataset(BaseDataset):
    def read_label(self, path):
        lbl = decode_png_file(path, self.unfilter, palette=False)  # 16-bit RGB: uint16
        if lbl is None:
            lbl = _pil_read(path, None)
        if lbl.ndim == 3:
            lbl = lbl[:, :, 0]
        return remap_label(np.clip(lbl, 0, 255).astype(np.uint8), "SYNTHIA")

    def build_aug_fn(self, aug_type):
        if not aug_type:
            return None
        if aug_type == "MS":
            ch, cw = self.cfg.dataset.crop_size
            return A.GeometricAug(ch, cw, (341, 640), w2h_ratio=2)
        if aug_type == "DACS":
            return A.ResizeCrop(760, 1280, 512, 512)
        if aug_type.startswith("PRS"):
            return A.Resize(*A.parse_resize_params(aug_type))
        if aug_type == "FDA-Target":
            return self.fda("target")
        raise ValueError(f"invalid aug_type {aug_type!r}")


@DATASET.register("Cityscapes")
class CityscapesDataset(BaseDataset):
    def read_label(self, path):
        if self.num_classes not in (9, 19):
            raise ValueError(f"Cityscapes has 19 or 9 classes, not {self.num_classes}")
        lbl = read_gray(path, self.unfilter)
        if self.num_classes == 9:  # Cityscapes -> Oxford scenario
            lbl = remap_label(lbl, "Cityscapes9")
        return lbl

    def build_aug_fn(self, aug_type):
        if not aug_type:
            return None
        if aug_type == "MS":
            ch, cw = self.cfg.dataset.crop_size
            return A.GeometricAug(ch, cw, (341, 1000), w2h_ratio=2)
        if aug_type == "OMS":
            return A.GeometricAug(768, 1024, (341, 1000), w2h_ratio=1280 / 960)
        if aug_type == "DACS":
            return A.ResizeCrop(512, 1024, 512, 512)
        if aug_type.startswith("PRS"):
            return A.Resize(*A.parse_resize_params(aug_type))
        if aug_type == "FDA-Source":
            return self.fda("source")
        if aug_type == "FDA-Target":
            return self.fda("target")
        raise ValueError(f"invalid aug_type {aug_type!r}")


@DATASET.register("Oxford")
class OxfordDataset(BaseDataset):
    def read_label(self, path):
        if self.num_classes != 9:
            raise ValueError(f"Oxford has 9 classes, not {self.num_classes}")
        if not path.endswith(".png"):  # the unlabelled train split
            return None
        lbl = decode_png_file(path, self.unfilter, palette=False)
        if lbl is None:
            lbl = _pil_read(path, None)
        if lbl.dtype == np.uint16:  # as PIL reads 16-bit files (module docstring)
            lbl = lbl.astype(np.uint8) if lbl.ndim == 2 else (lbl[:, :, 0] >> 8).astype(np.uint8)
        if lbl.ndim == 3:
            lbl = lbl[:, :, 0]
        return remap_label(np.ascontiguousarray(lbl), "Oxford")

    def build_aug_fn(self, aug_type):
        if not aug_type:
            return None
        if aug_type == "OMS":
            return A.GeometricAug(768, 1024, (341, 900), w2h_ratio=1280 / 960)
        if aug_type.startswith("PRS"):
            return A.Resize(*A.parse_resize_params(aug_type))
        if aug_type == "FDA-Source":
            return self.fda("source")
        raise ValueError(f"invalid aug_type {aug_type!r}")


def build_dataset(cfg, section, pseudo_dir=None, aug_type=None, num_classes=None, *, unfilter: Unfilter):
    """Instantiate the dataset named by a cfg.dataset.<section> block; its
    PNGs unfilter with ``unfilter`` (``png.unfilter_for`` the run's device)."""
    node = getattr(cfg.dataset, section)
    return DATASET[node.type](
        cfg,
        node.json_path,
        node.image_dir,
        pseudo_dir=pseudo_dir,
        aug_type=aug_type if aug_type is not None else list(getattr(node, "aug_type", [])),
        num_classes=num_classes or cfg.dataset.num_classes,
        unfilter=unfilter,
    )
