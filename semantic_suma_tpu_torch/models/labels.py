"""SemanticKITTI label table with display colours, the movable-class table
and ``is_movable`` (counterpart of ``semantic_suma_tpu/models/labels.py``;
the train-id tables come with the segmenter)."""

from __future__ import annotations

import numpy as np
import torch

# label id -> (name, (B, G, R)), SemanticKITTI raw ids
LABELS = {
    0: ("unlabeled", (0, 0, 0)),
    1: ("outlier", (0, 0, 255)),
    10: ("car", (245, 150, 100)),
    11: ("bicycle", (245, 230, 100)),
    13: ("bus", (250, 80, 100)),
    15: ("motorcycle", (150, 60, 30)),
    16: ("on-rails", (255, 0, 0)),
    18: ("truck", (180, 30, 80)),
    20: ("other-vehicle", (255, 0, 0)),
    30: ("person", (30, 30, 255)),
    31: ("bicyclist", (200, 40, 255)),
    32: ("motorcyclist", (90, 30, 150)),
    40: ("road", (255, 0, 255)),
    44: ("parking", (255, 150, 255)),
    48: ("sidewalk", (75, 0, 75)),
    49: ("other-ground", (75, 0, 175)),
    50: ("building", (0, 200, 255)),
    51: ("fence", (50, 120, 255)),
    52: ("other-structure", (0, 150, 255)),
    60: ("lane-marking", (170, 255, 150)),
    70: ("vegetation", (0, 175, 0)),
    71: ("trunk", (0, 60, 135)),
    72: ("terrain", (80, 240, 150)),
    80: ("pole", (150, 240, 255)),
    81: ("traffic-sign", (0, 0, 255)),
    99: ("other-object", (255, 255, 50)),
    252: ("moving-car", (245, 150, 100)),
    253: ("moving-person", (200, 40, 255)),
    254: ("moving-motorcyclist", (30, 30, 255)),
    255: ("moving-on-rails", (90, 30, 150)),
    256: ("moving-bicyclist", (255, 0, 0)),
    257: ("moving-bus", (250, 80, 100)),
    258: ("moving-truck", (180, 30, 80)),
    259: ("moving-other-vehicle", (255, 0, 0)),
}

# Movable classes penalized by the semantic pipeline.
MOVABLE_CLASSES = (10, 11, 13, 15, 18, 20, 30, 31, 32)

MAX_LABEL = 260


def _movable_lut() -> np.ndarray:
    lut = np.zeros((MAX_LABEL,), dtype=bool)
    for c in MOVABLE_CLASSES:
        lut[c] = True
    return lut


def _color_lut() -> np.ndarray:
    lut = np.zeros((MAX_LABEL, 3), dtype=np.uint8)
    for lid, (_, bgr) in LABELS.items():
        lut[lid] = bgr[::-1]  # store RGB
    return lut


_MOVABLE_LUT = _movable_lut()
_COLOR_LUT = _color_lut()

# All movable ids are < 64, so membership is one shift of a 64-bit mask: no
# lookup table has to live on the device.
_MOVABLE_MASK = 0
for _c in MOVABLE_CLASSES:
    if _c >= 63:  # pragma: no cover - all current movable ids are < 63
        raise AssertionError("movable class id >= 63 needs the LUT path")
    _MOVABLE_MASK |= 1 << _c


def is_movable(labels: torch.Tensor) -> torch.Tensor:
    """Elementwise movable-class test; ids outside [0, 64) are not movable."""
    li = labels.to(torch.int64)
    inside = (li >= 0) & (li < 64)
    bit = (torch.full_like(li, _MOVABLE_MASK) >> li.clamp(0, 63)) & 1
    return inside & (bit > 0)


def label_colors(labels: np.ndarray) -> np.ndarray:
    """RGB uint8 colours for display and export (host numpy)."""
    return _COLOR_LUT[np.clip(np.asarray(labels, dtype=np.int64), 0,
                              MAX_LABEL - 1)]
