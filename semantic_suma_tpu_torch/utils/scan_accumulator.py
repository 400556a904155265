"""Ring buffer of recent scans and their poses (counterpart of
``semantic_suma_tpu/utils/scan_accumulator.py``): feeds the CLI's
``--save-cloud`` export with an aggregated world-frame cloud. Host numpy
only: a scan given as a tensor is copied to the host on insert."""

from __future__ import annotations

from collections import deque
from typing import Deque, Optional, Tuple

import numpy as np
import torch


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class ScanAccumulator:
    def __init__(self, history_size: int = 100, stride: int = 1):
        self.history_size = history_size
        self.stride = stride
        self._buf: Deque[Tuple[np.ndarray, np.ndarray]] = deque(
            maxlen=history_size)
        self._i = 0

    def insert(self, points, pose, valid=None) -> None:
        if self._i % self.stride == 0:
            pts = _np(points).astype(np.float32)
            if valid is not None:
                pts = pts[_np(valid).astype(bool)]
            self._buf.append((pts, _np(pose).astype(np.float32)))
        self._i += 1

    def size(self) -> int:
        return len(self._buf)

    def world_cloud(self, max_points: Optional[int] = None) -> np.ndarray:
        """All buffered scans transformed into the world frame, [M, 3]."""
        clouds = [pts @ pose[:3, :3].T + pose[:3, 3]
                  for pts, pose in self._buf]
        if not clouds:
            return np.zeros((0, 3), np.float32)
        cloud = np.concatenate(clouds)
        if max_points is not None and cloud.shape[0] > max_points:
            sel = np.random.default_rng(0).choice(
                cloud.shape[0], max_points, replace=False)
            cloud = cloud[sel]
        return cloud

    def clear(self) -> None:
        self._buf.clear()
        self._i = 0
