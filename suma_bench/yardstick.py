"""The benchmark's yardstick, frozen here so that a later change to the port
cannot move it: the trajectory error arithmetic (a copy of the port's
``utils/metrics.py``: the aligned ATE and the KITTI devkit's t_rel/r_rel),
the published peaks of one NVIDIA H100, and kernel F's bytes computed from
shapes. A segmentation network's forward FLOPs are its own module's,
``nets/<arch>.py``."""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W limit
H100_BF16_FLOPS = 989e12
H100_HBM_BYTES_PER_S = 3.35e12

SEGMENT_LENGTHS = (100.0, 200.0, 300.0, 400.0, 500.0, 600.0, 700.0, 800.0)
STEP_SIZE = 10  # start-frame stride in the devkit


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


def kitti_rel_errors(gt: np.ndarray, est: np.ndarray) -> tuple:
    """The devkit's averages over its segments: ``(t_rel %, r_rel deg per
    100 m)``, NaN where the trajectory is shorter than 100 m."""
    n = min(len(gt), len(est))
    gt, est = gt[:n], est[:n]
    dist = np.concatenate([[0.0], np.cumsum(np.linalg.norm(
        np.diff(gt[:, :3, 3], axis=0), axis=-1))])
    t_errs, r_errs = [], []
    for first in range(0, n, STEP_SIZE):
        for length in SEGMENT_LENGTHS:
            last = int(np.searchsorted(dist, dist[first] + length))
            if last >= n:
                continue
            err = np.linalg.inv(np.linalg.inv(est[first]) @ est[last]) \
                @ (np.linalg.inv(gt[first]) @ gt[last])
            a = 0.5 * (np.trace(err[:3, :3]) - 1.0)
            r_errs.append(float(np.arccos(np.clip(a, -1.0, 1.0))) / length)
            t_errs.append(float(np.linalg.norm(err[:3, 3])) / length)
    if not t_errs:
        return float("nan"), float("nan")
    return (float(np.mean(t_errs)) * 100.0,
            float(np.mean(r_errs)) * 180.0 / np.pi * 100.0)


# kernel F's state (pose and counters, float32 and int32 words), read and
# written once a call
GN_STATE_BYTES = 112


def gn_call_bytes(data_pixels: int, model_cells: int) -> int:
    """Bytes one Gauss-Newton or ``evaluate`` call needs, each once: a data
    pixel's vertex and normal (24 B), two valid bytes, label and probability
    (8 B); a model cell of the packed model image (32 B); the state read and
    written. 3,801,824 B for a 64x900 scan against a 64x900 model."""
    return data_pixels * 34 + model_cells * 32 + 2 * GN_STATE_BYTES
