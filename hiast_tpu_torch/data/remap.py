"""Label-id remapping tables as 256-entry LUTs (the port's own copy).

The reference remaps raw dataset ids to train ids with a per-key Python loop
(reference: code/sseg/datasets/utils.py:58-64); a LUT gather does the same in
one vectorized op.  The id maps themselves are the standard Cityscapes
trainId conventions used by each dataset loader (reference:
code/sseg/datasets/loader/gtav_dataset.py:11, synthia_dataset.py:11,
cityscapes_dataset.py:12, oxford_dataset.py:12).
"""
from __future__ import annotations

import numpy as np

IGNORE = 255

# GTA5 labelIds -> 19 train ids
GTAV_ID_MAP = {
    7: 0, 8: 1, 11: 2, 12: 3, 13: 4, 17: 5, 19: 6, 20: 7, 21: 8, 22: 9,
    23: 10, 24: 11, 25: 12, 26: 13, 27: 14, 28: 15, 31: 16, 32: 17, 33: 18,
}

# SYNTHIA ids -> 19-slot train ids (only 16 classes exist)
SYNTHIA_ID_MAP = {
    3: 0, 4: 1, 2: 2, 21: 3, 5: 4, 7: 5, 15: 6, 9: 7, 6: 8, 16: 9,
    1: 10, 10: 11, 17: 12, 8: 13, 18: 14, 19: 15, 20: 16, 12: 17, 11: 18,
}

# Cityscapes 19 train ids -> 9 classes (Cityscapes -> Oxford RobotCar)
CITYSCAPES_TO_9_ID_MAP = {
    0: 8, 1: 7, 2: 6, 3: 255, 4: 255, 5: 255, 6: 5, 7: 4, 8: 255, 9: 255,
    10: 0, 11: 1, 12: 1, 13: 3, 14: 3, 15: 3, 16: 255, 17: 2, 18: 2,
}

# Oxford RobotCar raw ids -> 9 classes
OXFORD_ID_MAP = {
    1: 0, 2: 1, 3: 2, 4: 3, 5: 4, 6: 5, 7: 6, 10: 7, 11: 8, 12: 8, 13: 8,
    14: 8, 17: 8,
}


def make_lut(id_map: dict[int, int]) -> np.ndarray:
    lut = np.full(256, IGNORE, np.uint8)
    for k, v in id_map.items():
        lut[k] = v
    return lut


_LUTS = {
    "GTAV": make_lut(GTAV_ID_MAP),
    "SYNTHIA": make_lut(SYNTHIA_ID_MAP),
    "Cityscapes9": make_lut(CITYSCAPES_TO_9_ID_MAP),
    "Oxford": make_lut(OXFORD_ID_MAP),
}


def remap_label(lbl: np.ndarray, dataset: str) -> np.ndarray:
    """Vectorized raw-id -> train-id conversion."""
    return _LUTS[dataset][lbl]
