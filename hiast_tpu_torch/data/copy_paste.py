"""Cross-image pasting preprocessors: hard-aware copy-paste (HPA),
ClassMix and CutMix.

The port of ``hiast_tpu/data/copy_paste.py`` (reference:
code/sseg/datasets/preprocessor.py:11-122), numpy only.  ``CopyPaste``:

- the hard classes are the ``selected_num_classes`` classes of lowest mean
  selected confidence (``class_mean_probabilities.npy`` of the previous
  generation); with a SYNTHIA source its 3 absent classes {9, 14, 16} are
  set to +inf, so they are never hard and never drawn;
- a donor CLASS is drawn with probability proportional to (1 - p)^2 over
  all classes and redrawn until it is one of the hard classes still to
  paste; degenerate statistics (every p == 1) draw uniformly over the
  present classes;
- a donor IMAGE is drawn from ``samples_with_class[class]``, and ALL its
  hard-class pixels are pasted into the image and the label, and recorded
  in ``copy_paste_mask`` (255 elsewhere);
- the reference's donor loop marks every hard class as pasted after the
  first donor, whatever that donor holds (preprocessor.py:106-110), so it
  stops after one donor; the loop keeps the reference's shape and
  accounting, and with it that behaviour.

``ClassMix`` (arXiv:2007.07936) pastes half the classes of a random
donor image, ``CutMix`` (arXiv:1905.04899) one random rectangle of it;
the reference names both and implements neither, and no shipped config
uses them.  Each preprocessor returns (image, label, ``copy_paste_mask``),
the mask holding the pasted donor labels and 255 elsewhere.

Every draw comes from the sample's ``np.random.Generator`` in the JAX
package's order, so one seed gives the same donors, bit for bit.  The
pixel work goes through the donor dataset's ``host`` ops
(``data/native_ops.py``, the port's C++ beside a card): a donor of another
size is resized to the sample's with its ``resize_linear`` /
``resize_nearest`` (the JAX package uses cv2), and CopyPaste and ClassMix
paste with its ``paste_hard_classes`` (``paste_hard_classes`` below is the
plain version).  CutMix's box is a slice copy.
"""
from __future__ import annotations

import numpy as np

from hiast_tpu_torch.registry import PREPROCESSOR

IGNORE = 255
SYNTHIA_ABSENT = (9, 14, 16)


def _fitted(dataset, index: int, shape):
    """Image ``index`` of ``dataset`` and its label, resized to ``shape``
    (the sample's) where they differ."""
    d_img, d_lbl, _ = dataset.load_data(index)
    if d_img.shape != shape:
        d_img = dataset.host.resize_linear(d_img, shape[0], shape[1])
        d_lbl = dataset.host.resize_nearest(d_lbl, shape[0], shape[1])
    return d_img, d_lbl


def paste_hard_classes(img, lbl, cp_mask, donor_img, donor_lbl, hard_lut) -> None:
    """Paste in place the donor's pixels whose label is hard
    (``hard_lut[label]``, a bool [256] table) into ``img``, ``lbl`` and
    ``cp_mask`` (``hiast_tpu/data/native_ops.py:paste_hard_classes``): the
    plain version of ``data/native_ops.py:paste_hard_classes_native``."""
    mask = hard_lut[donor_lbl]
    img[mask] = donor_img[mask]
    lbl[mask] = donor_lbl[mask]
    cp_mask[mask] = donor_lbl[mask]


@PREPROCESSOR.register("CopyPaste")
class CopyPaste:
    def __init__(self, cfg, dataset_copy_from, init_class_value: np.ndarray):
        self.cfg = cfg
        self.dataset = dataset_copy_from
        mode = cfg.preprocessor.copy_paste.mode
        if mode != "original":  # the reference rejects its other modes too (preprocessor.py:64-68)
            raise ValueError(f"unsupported preprocessor.copy_paste.mode {mode!r}: only 'original'")

        class_value = np.asarray(init_class_value, np.float64).copy()
        if cfg.dataset.source.type == "SYNTHIA":
            class_value[list(SYNTHIA_ABSENT)] = np.inf

        k = cfg.preprocessor.copy_paste.selected_num_classes
        self.class_value = class_value
        self.hard_classes = np.argsort(class_value)[:k]
        self.samples_with_class = dataset_copy_from.get_samples_with_class()
        probs = (1.0 - np.where(np.isfinite(class_value), class_value, 1.0)) ** 2
        if probs.sum() <= 0:  # degenerate stats (every mean probability is 1)
            probs = np.ones_like(probs)
            probs[~np.isfinite(class_value)] = 0.0
        self.class_probs = probs / probs.sum()
        self.hard_lut = np.zeros(256, bool)
        self.hard_lut[self.hard_classes] = True

    def _random_select(self, selected_classes, rng: np.random.Generator) -> int:
        """A class drawn from the (1 - p)^2 distribution, redrawn until it
        lands in ``selected_classes`` (reference preprocessor.py:70-77)."""
        selected = {int(c) for c in selected_classes}
        while True:
            c = int(rng.choice(len(self.class_probs), p=self.class_probs))
            if c in selected:
                return c

    def run(self, img: np.ndarray, lbl: np.ndarray, rng: np.random.Generator):
        """-> (image, label, copy_paste_mask), new arrays."""
        img = img.copy()
        lbl = lbl.copy()
        cp_mask = np.full_like(lbl, IGNORE)
        selected_classes = list(self.hard_classes)
        exist_classes: list[int] = []
        for _ in range(self.cfg.preprocessor.copy_paste.max_donors):
            select_c = self._random_select(selected_classes, rng)
            donors = self.samples_with_class[select_c]
            if not donors:
                break
            file_name = donors[int(rng.integers(0, len(donors)))]
            d_img, d_lbl = _fitted(self.dataset, self.dataset.get_file_to_idx(file_name), img.shape)
            for c in self.hard_classes:
                if c in selected_classes and c not in exist_classes:
                    exist_classes.append(int(c))
            self.dataset.host.paste_hard_classes(img, lbl, cp_mask, d_img, d_lbl, self.hard_lut)
            if len(exist_classes) >= len(self.hard_classes) * 0.5:
                break
            selected_classes = [c for c in self.hard_classes if c not in exist_classes]
        return img, lbl, cp_mask


def _donor(dataset, shape, rng: np.random.Generator):
    """A random image of ``dataset`` (its index drawn first from ``rng``)
    and its label, resized to ``shape`` where they differ."""
    return _fitted(dataset, int(rng.integers(0, len(dataset))), shape)


@PREPROCESSOR.register("ClassMix")
class ClassMix:
    """Paste half the classes present in a random donor (at least one),
    chosen by ``rng.choice`` without replacement after the donor's index."""

    def __init__(self, cfg, dataset_copy_from, init_class_value=None):
        self.cfg = cfg
        self.dataset = dataset_copy_from

    def run(self, img: np.ndarray, lbl: np.ndarray, rng: np.random.Generator):
        img = img.copy()
        lbl = lbl.copy()
        cp_mask = np.full_like(lbl, IGNORE)
        d_img, d_lbl = _donor(self.dataset, img.shape, rng)
        classes = np.unique(d_lbl)
        classes = classes[classes != IGNORE]
        if classes.size == 0:
            return img, lbl, cp_mask
        chosen = rng.choice(classes, size=max(classes.size // 2, 1), replace=False)
        lut = np.zeros(256, bool)
        lut[chosen] = True
        self.dataset.host.paste_hard_classes(img, lbl, cp_mask, d_img, d_lbl, lut)
        return img, lbl, cp_mask


@PREPROCESSOR.register("CutMix")
class CutMix:
    """Paste one rectangle of a random donor: the donor's index, then
    lam ~ Beta(1, 1), a box of sides sqrt(1 - lam) of the sample's (at
    least 1 pixel), its corner drawn y0 then x0."""

    beta = 1.0  # the JAX default, which no caller changes

    def __init__(self, cfg, dataset_copy_from, init_class_value=None):
        self.cfg = cfg
        self.dataset = dataset_copy_from

    def run(self, img: np.ndarray, lbl: np.ndarray, rng: np.random.Generator):
        img = img.copy()
        lbl = lbl.copy()
        cp_mask = np.full_like(lbl, IGNORE)
        d_img, d_lbl = _donor(self.dataset, img.shape, rng)
        h, w = lbl.shape
        cut = np.sqrt(1.0 - rng.beta(self.beta, self.beta))
        ch, cw = max(int(h * cut), 1), max(int(w * cut), 1)
        y0 = int(rng.integers(0, h - ch + 1))
        x0 = int(rng.integers(0, w - cw + 1))
        box = (slice(y0, y0 + ch), slice(x0, x0 + cw))
        img[box] = d_img[box]
        lbl[box] = d_lbl[box]
        cp_mask[box] = d_lbl[box]
        return img, lbl, cp_mask
