"""KITTI odometry evaluation metrics (numpy only; counterpart of
``semantic_suma_tpu/utils/metrics.py``): the devkit's relative segment
errors and the aligned absolute trajectory error."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

SEGMENT_LENGTHS = (100.0, 200.0, 300.0, 400.0, 500.0, 600.0, 700.0, 800.0)
STEP_SIZE = 10  # start-frame stride in the devkit


@dataclass
class SegmentError:
    first_frame: int
    r_err: float  # rad per meter
    t_err: float  # fraction per meter
    length: float
    speed: float


def trajectory_distances(poses: np.ndarray) -> np.ndarray:
    """Cumulative path length."""
    d = np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=-1)
    return np.concatenate([[0.0], np.cumsum(d)])


def _last_frame_from_segment(dist: np.ndarray, first: int,
                             length: float) -> int:
    idx = np.searchsorted(dist, dist[first] + length)
    return int(idx) if idx < len(dist) else -1


def rotation_error(rel: np.ndarray) -> float:
    a = 0.5 * (np.trace(rel[:3, :3]) - 1.0)
    return float(np.arccos(np.clip(a, -1.0, 1.0)))


def translation_error(rel: np.ndarray) -> float:
    return float(np.linalg.norm(rel[:3, 3]))


def calc_sequence_errors(gt: np.ndarray, est: np.ndarray) -> List[SegmentError]:
    """Per-(start, length) segment errors of the KITTI devkit."""
    n = min(len(gt), len(est))
    gt, est = gt[:n], est[:n]
    dist = trajectory_distances(gt)
    errors: List[SegmentError] = []
    for first in range(0, n, STEP_SIZE):
        for length in SEGMENT_LENGTHS:
            last = _last_frame_from_segment(dist, first, length)
            if last < 0 or last >= n:
                continue
            gt_rel = np.linalg.inv(gt[first]) @ gt[last]
            est_rel = np.linalg.inv(est[first]) @ est[last]
            err = np.linalg.inv(est_rel) @ gt_rel
            speed = length / (0.1 * (last - first))  # 10 Hz
            errors.append(SegmentError(
                first_frame=first, r_err=rotation_error(err) / length,
                t_err=translation_error(err) / length, length=length,
                speed=speed))
    return errors


def ate_rmse(gt: np.ndarray, est: np.ndarray, align: bool = True) -> float:
    """Absolute trajectory error RMSE over positions, with optional SE(3)
    (Umeyama, no scale) alignment."""
    n = min(len(gt), len(est))
    p_gt = gt[:n, :3, 3]
    p_est = est[:n, :3, 3]
    if align and n >= 3:
        mu_g, mu_e = p_gt.mean(0), p_est.mean(0)
        x = p_est - mu_e
        y = p_gt - mu_g
        u, _, vt = np.linalg.svd(x.T @ y)
        s = np.eye(3)
        if np.linalg.det(u @ vt) < 0:
            s[2, 2] = -1
        r = (u @ s @ vt).T
        p_est = (r @ x.T).T + mu_g
    return float(np.sqrt(np.mean(np.sum((p_est - p_gt) ** 2, axis=-1))))
