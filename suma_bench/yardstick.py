"""The benchmark's yardstick, frozen here so that a later change to the port
cannot move it: the trajectory error arithmetic (a copy of the port's
``utils/metrics.py``: the aligned ATE and the KITTI devkit's t_rel/r_rel),
the published peaks of one NVIDIA H100, and the work of each measured part
computed from shapes (kernel F's bytes, the segmenter's forward FLOPs)."""

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


def _same_out(size: int, stride: int) -> int:
    return -(-size // stride)


def rangenet_forward_flops(height: int, width: int, stage_blocks, widths,
                           num_classes: int = 20, in_channels: int = 5) -> int:
    """Multiply-adds times two of one forward of the darknet RangeNet of
    ``stage_blocks`` and ``widths`` on one ``height x width`` image, the width
    wrap-padded to a multiple of ``2 ** len(stage_blocks)``: every
    convolution ``2 * cout * cin * kh * kw * out_h * out_w``, every transposed
    convolution ``2 * cin * cout * kh * kw * in_h * in_w``; batch norms,
    activations and sums are left out (under 0.1%)."""
    w = width + (-width) % (2 ** len(stage_blocks))
    h = height
    flops = 0

    def conv(cin, cout, k, wi, stride=1):
        nonlocal flops
        wo = _same_out(wi, stride)
        flops += 2 * cout * cin * k[0] * k[1] * h * wo
        return wo

    c = widths[0]
    cur = conv(in_channels, c, (3, 3), w)
    cols = [cur]
    for blocks, width_ in zip(stage_blocks, widths[1:]):
        cur = conv(c, width_, (3, 3), cur, 2)
        for _ in range(blocks):
            conv(width_, width_ // 2, (1, 1), cur)
            conv(width_ // 2, width_, (3, 3), cur)
        c = width_
        cols.append(cur)
    for width_ in reversed(widths[:-1]):
        flops += 2 * c * width_ * 1 * 4 * h * cur   # (1, 4) stride (1, 2)
        cur *= 2
        conv(width_, width_, (1, 1), cur)
        conv(width_, width_ // 2, (1, 1), cur)
        conv(width_ // 2, width_, (3, 3), cur)
        c = width_
    conv(widths[0], num_classes, (1, 1), cur)
    return flops
