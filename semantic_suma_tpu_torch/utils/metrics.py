"""KITTI odometry evaluation metrics (numpy only; counterpart of
``semantic_suma_tpu/utils/metrics.py``): the devkit's relative segment
errors, their averages and per-length / per-speed tables, the aligned
absolute trajectory error, and :func:`evaluate`, the summary the CLI
prints."""

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


def average_errors(errors: List[SegmentError]) -> tuple[float, float]:
    """(t_rel %, r_rel deg per 100 m) devkit-style averages."""
    if not errors:
        return float("nan"), float("nan")
    t = float(np.mean([e.t_err for e in errors])) * 100.0
    r = float(np.mean([e.r_err for e in errors])) * 180.0 / np.pi * 100.0
    return t, r


def errors_by_length(errors: List[SegmentError]) -> dict:
    """Per-segment-length table: length -> {t_rel %, r_rel deg/100m,
    count}."""
    out = {}
    for length in SEGMENT_LENGTHS:
        sub = [e for e in errors if e.length == length]
        if not sub:
            continue
        t, r = average_errors(sub)
        out[f"{length:.0f}m"] = {"t_rel_percent": t,
                                 "r_rel_deg_per_100m": r,
                                 "count": len(sub)}
    return out


def errors_by_speed(errors: List[SegmentError], bin_mps: float = 2.0) -> dict:
    """Per-speed table: speed bucket (m/s, binned every ``bin_mps``) ->
    {t_rel %, r_rel deg/100m, count}."""
    out = {}
    for b in sorted({int(e.speed // bin_mps) for e in errors}):
        sub = [e for e in errors if int(e.speed // bin_mps) == b]
        t, r = average_errors(sub)
        out[f"{b * bin_mps:.0f}-{(b + 1) * bin_mps:.0f}m/s"] = {
            "t_rel_percent": t, "r_rel_deg_per_100m": r, "count": len(sub)}
    return out


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


def evaluate(gt: np.ndarray, est: np.ndarray,
             breakdown: bool = False) -> dict:
    """Evaluation summary: devkit t_rel / r_rel, aligned and unaligned ATE,
    the final-position error relative to the first pose, the number of
    segments and the path length. ``breakdown=True`` adds the
    per-segment-length and per-speed tables."""
    errors = calc_sequence_errors(gt, est)
    t_rel, r_rel = average_errors(errors)
    n = min(len(gt), len(est))
    out = {
        "t_rel_percent": t_rel,
        "r_rel_deg_per_100m": r_rel,
        "ate_rmse_m": ate_rmse(gt, est),
        "ate_rmse_noalign_m": ate_rmse(gt, est, align=False),
        "final_error_m": float(np.linalg.norm(
            (np.linalg.inv(gt[0]) @ gt[n - 1])[:3, 3]
            - (np.linalg.inv(est[0]) @ est[n - 1])[:3, 3])),
        "num_segments": len(errors),
        "length_m": float(trajectory_distances(gt[:n])[-1]),
    }
    if breakdown:
        out["by_length"] = errors_by_length(errors)
        out["by_speed"] = errors_by_speed(errors)
    return out
