"""SemanticKITTI label table with display colours, the movable-class table
and ``is_movable``, and the segmenter's train-id tables (counterpart of
``semantic_suma_tpu/models/labels.py``)."""

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

# The 20-class training label set used by RangeNet++ (learning id order).
TRAIN_CLASSES = (0, 10, 11, 15, 18, 20, 30, 31, 32, 40, 44, 48, 49, 50, 51,
                 70, 71, 72, 80, 81)


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

# train id <-> raw label tables (host numpy; a device copy is made once per
# device by ``_device_table``)
_TRAIN_TO_RAW = np.array(TRAIN_CLASSES, dtype=np.int32)
_RAW_TO_TRAIN = np.zeros((MAX_LABEL,), dtype=np.int32)
for _i, _c in enumerate(TRAIN_CLASSES):
    _RAW_TO_TRAIN[_c] = _i
# moving classes map to their static counterparts for training
for _mov, _stat in ((252, 10), (253, 30), (254, 32), (255, 16), (256, 31),
                    (257, 13), (258, 18), (259, 20)):
    if _stat in TRAIN_CLASSES:
        _RAW_TO_TRAIN[_mov] = TRAIN_CLASSES.index(_stat)

_device_tables: dict = {}


def _device_table(name: str, device: torch.device) -> torch.Tensor:
    """The table ``name`` on ``device``, uploaded on first use: a per-call
    upload from pageable memory would make the host wait for the device."""
    key = (name, device)
    t = _device_tables.get(key)
    if t is None:
        host = _RAW_TO_TRAIN if name == "raw_to_train" else _TRAIN_TO_RAW
        t = torch.as_tensor(host, device=device)
        _device_tables[key] = t
    return t

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


def raw_to_train(labels: torch.Tensor) -> torch.Tensor:
    """Raw SemanticKITTI ids -> train ids (int32; ids clipped to [0, 260))."""
    idx = labels.to(torch.int64).clamp(0, MAX_LABEL - 1)
    return _device_table("raw_to_train", labels.device)[idx]


def train_to_raw(train_ids: torch.Tensor) -> torch.Tensor:
    """Train ids -> raw SemanticKITTI ids (int32; ids clipped to the set)."""
    idx = train_ids.to(torch.int64).clamp(0, len(TRAIN_CLASSES) - 1)
    return _device_table("train_to_raw", train_ids.device)[idx]
