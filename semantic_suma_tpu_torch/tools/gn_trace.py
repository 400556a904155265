"""Why some scans run Gauss-Newton to its iteration cap.

    python3 -m semantic_suma_tpu_torch.tools.gn_trace [--filter kernel|plain]
                                                      [--scans 68] [--cpu]

Runs the odometry path (``odometry_config()``, bilateral filter on) over the
synthetic world that ``chip_smoke.py`` drives, records every Gauss-Newton
iteration (weighted error, inliers, the step's largest component, the largest
component of the gradient) and prints, for each scan, the test that stopped
its loop, and for each scan that reached the cap the whole trace with the
period of its tail: the smallest p for which every step of the last 12
iterations repeats the step p iterations earlier to within 5% of the largest
of them, 0 when there is none up to 6. ``--filter plain`` runs the
plain PyTorch bilateral filter in the kernel's place. The recording keeps
device tensors and reads them after each scan, so it changes no value.

To see every iteration, the trace keeps the host loop: each alignment runs
``icp.gauss_newton_host`` (``build_rows``, ``rows.T @ rows``, the solve and
one host read an iteration), not kernel F's one-launch loop that the
odometry step runs on a card, so its sums round in another order.
"""

from __future__ import annotations

import argparse
from collections import Counter

import numpy as np
import torch

from ..config import odometry_config
from ..core import preprocessing
from ..core.pipeline import SurfelSLAM
from ..io.simulation import circular_trajectory, default_world, render_scan
from ..ops import icp
from ..ops.bilateral import bilateral_filter_plain
from ..utils.metrics import ate_rmse


class _Recorder:
    """Routes ``icp.gauss_newton`` to ``icp.gauss_newton_host``, wraps the
    two functions each of its iterations calls, and keeps what they saw of
    a scan's first loop (a second one is the recovery after a track
    loss)."""

    def __init__(self):
        self.iterations: list = []
        self.loops = 0
        self._wrapped = (icp.gauss_newton, icp.build_rows, icp._solve_spd)
        icp.gauss_newton = self.gauss_newton
        icp.build_rows = self.build_rows
        icp._solve_spd = self.solve_spd

    def close(self):
        icp.gauss_newton, icp.build_rows, icp._solve_spd = self._wrapped

    def gauss_newton(self, *args, **kwargs):
        self.loops += 1
        return icp.gauss_newton_host(*args, **kwargs)

    def build_rows(self, *args, **kwargs):
        rows, stats = self._wrapped[1](*args, **kwargs)
        if self.loops == 1:
            self.iterations.append([stats.error,
                                    stats.inlier.to(torch.float32)])
        return rows, stats

    def solve_spd(self, jtj, rhs):
        delta = self._wrapped[2](jtj, rhs)
        if self.loops == 1:
            self.iterations[-1] += [torch.max(torch.abs(delta)),
                                    torch.abs(torch.max(-rhs)), delta]
        return delta

    def take(self):
        """(error, inliers, |step|_inf, |max gradient|)[K, 4] and the steps
        [K, 6] of the iterations since the last call."""
        its, self.iterations, self.loops = self.iterations, [], 0
        head = torch.stack([torch.stack(it[:4]) for it in its]).cpu().numpy()
        steps = torch.stack([it[4] for it in its]).cpu().numpy()
        return head, steps


def _stopped_by(head: np.ndarray, cfg) -> str:
    """The test of ``gauss_newton`` that ended the loop at its last
    iteration, in the order the loop evaluates them."""
    err, _, step, grad = head[-1]
    last = head[-2][0] if len(head) > 1 else np.inf
    if step < cfg.delta:
        return "step"
    if grad < cfg.stopping_threshold:
        return "gradient"
    if err < last and abs(err - last) < cfg.stopping_threshold:
        return "error"
    return "cap" if len(head) >= cfg.max_iterations else "other"


def _period(steps: np.ndarray, tail: int = 12) -> int:
    """Smallest p for which each of the last ``tail`` steps repeats the step
    p iterations earlier to within 5% of the largest of them; 0 when there
    is none up to tail / 2. Period 1 is a loop that creeps by equal steps,
    period 2 one that jumps between two poses."""
    last = steps[-tail:].astype(np.float64)
    tol = 0.05 * np.abs(last).max()
    for p in range(1, tail // 2 + 1):
        if np.abs(last[p:] - last[:-p]).max() <= tol:
            return p
    return 0


def trace_run(cfg, n_scans: int, dev, label: str = ""):
    """Run ``n_scans`` scans of the synthetic world through ``SurfelSLAM``
    with every Gauss-Newton iteration recorded and printed as the module
    says. Returns (the SurfelSLAM, iterations per scan, stopping test per
    scan)."""
    world = default_world(seed=0, extent=45.0)
    gt = circular_trajectory(n_scans, radius=18.0, step=1.5, device=dev)
    slam = SurfelSLAM(cfg, device=dev)
    rec = _Recorder()
    counts, reasons = [], []
    try:
        for i in range(n_scans):
            s = render_scan(world, gt[i], cfg.data)
            slam.process_scan(s.points, s.labels, s.probs, s.valid)
            head, steps = rec.take()
            why = _stopped_by(head, cfg.icp)
            counts.append(len(head))
            reasons.append(why)
            print(f"[gn] scan {i}: {len(head)} iterations, stopped by {why}, "
                  f"last |step|_inf {head[-1][2]:.3e}, error "
                  f"{head[-1][0]:.6f}, inliers {int(head[-1][1])}")
            if why != "cap":
                continue
            tail = head[-12:]
            print(f"[gn]   tail of 12: |step|_inf {tail[:, 2].min():.3e} to "
                  f"{tail[:, 2].max():.3e} (stops below {cfg.icp.delta:g}), "
                  f"error {tail[:, 0].min():.6f} to {tail[:, 0].max():.6f}, "
                  f"inliers {int(tail[:, 1].min())} to "
                  f"{int(tail[:, 1].max())}, period {_period(steps)}")
            for k, (err, inl, step, grad) in enumerate(head):
                print(f"[gn]   it {k:2d}: error {err:.6f} inliers {int(inl)} "
                      f"|step|_inf {step:.3e} |gradient| {grad:.3e}")
    finally:
        rec.close()
    ate = ate_rmse(gt.cpu().numpy().astype(np.float64), slam.trajectory())
    print(f"[gn] {label}{n_scans} scans, {np.mean(counts):.2f} "
          f"iterations/scan, stopped by {dict(Counter(reasons))}, aligned ATE "
          f"{ate:.5f} m, map surfels {slam.statistics[-1]['map-count']}")
    return slam, counts, reasons


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--filter", choices=("kernel", "plain"), default="kernel")
    ap.add_argument("--scans", type=int, default=68)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (use a small --scans)")
    args = ap.parse_args()
    if args.filter == "plain":
        preprocessing.bilateral_filter = bilateral_filter_plain
    trace_run(odometry_config(), args.scans,
              torch.device("cpu" if args.cpu else "cuda"),
              f"filter {args.filter}: ")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
