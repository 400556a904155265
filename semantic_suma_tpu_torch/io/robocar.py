"""Oxford RobotCar-format binary scan reader (counterpart of
``semantic_suma_tpu/io/robocar.py``).

Lists the ``.bin`` scans of a RobotCar LiDAR directory and decodes each file
as a flat sequence of 3 float64 values per point (x, y, z), negating y and z
to bring the cloud into the engine's sensor frame. The format has no
remissions and no semantics: remissions are zero, labels "unlabeled" (0)
and probabilities one.
"""

from __future__ import annotations

import os

import numpy as np

from .kitti import KittiScan


class RobocarReader:
    """read/count/seek over the RobotCar ``.bin`` files of ``scan_dir``."""

    def __init__(self, scan_dir: str):
        self.files = sorted(
            os.path.join(scan_dir, f) for f in os.listdir(scan_dir)
            if f.endswith(".bin"))
        if not self.files:
            raise FileNotFoundError(f"no .bin scans under {scan_dir}")

    def count(self) -> int:
        return len(self.files)

    def is_seekable(self) -> bool:
        return True

    def read(self, idx: int) -> KittiScan:
        raw = np.fromfile(self.files[idx], dtype=np.float64)
        pts = raw.reshape(-1, 3).astype(np.float32)
        points = pts * np.array([1.0, -1.0, -1.0], np.float32)
        n = points.shape[0]
        return KittiScan(points=points,
                         remissions=np.zeros(n, np.float32),
                         labels=np.zeros(n, np.int32),
                         probs=np.ones(n, np.float32))
