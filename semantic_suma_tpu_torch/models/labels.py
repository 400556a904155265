"""SemanticKITTI movable-class table and ``is_movable`` (counterpart of
``semantic_suma_tpu/models/labels.py``)."""

from __future__ import annotations

import numpy as np
import torch

# Movable classes penalized by the semantic pipeline.
MOVABLE_CLASSES = (10, 11, 13, 15, 18, 20, 30, 31, 32)

MAX_LABEL = 260


def _movable_lut() -> np.ndarray:
    lut = np.zeros((MAX_LABEL,), dtype=bool)
    for c in MOVABLE_CLASSES:
        lut[c] = True
    return lut


_MOVABLE_LUT = _movable_lut()

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
