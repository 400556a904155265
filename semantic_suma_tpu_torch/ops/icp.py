"""Frame-to-model projective ICP: weighted Jacobian rows, one [P,8]^T[P,8]
product per linearization, and the Gauss-Newton loop (counterpart of
``semantic_suma_tpu/ops/icp.py``).

The JAX package runs the whole loop as one device ``while_loop``; here the
loop is a Python loop with one host read per iteration (the stopping test,
through ``device.to_host``). With a ``group`` (the sharded pipeline,
``parallel/``), each rank linearizes its slice of the image rows and the
products and statistics are summed over the ranks once per iteration, so
every rank takes the same step and stops at the same iteration.
Twist convention ``x = [v, omega]``, increment applied on the left:
``pose <- exp(x) @ pose``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..config import DataConfig, IcpConfig
from ..device import to_host
from ..models.labels import is_movable
from ..utils import lie
from .projection import INV_PI

_DEG = 180.0 / math.pi


class Maps(NamedTuple):
    """Dense per-frame maps."""

    vertex: torch.Tensor        # [H, W, 3]
    normal: torch.Tensor        # [H, W, 3]
    vertex_valid: torch.Tensor  # [H, W] bool
    normal_valid: torch.Tensor  # [H, W] bool
    sem_label: torch.Tensor     # [H, W] int32
    sem_prob: torch.Tensor      # [H, W] float32

    @property
    def valid(self):
        return self.vertex_valid & self.normal_valid


class IcpStats(NamedTuple):
    error: torch.Tensor            # sum of weighted squared residuals
    valid: torch.Tensor            # associated terms (inlier + outlier)
    inlier: torch.Tensor
    outlier: torch.Tensor
    inlier_residual: torch.Tensor
    invalid: torch.Tensor          # data pixels with no model association


class IcpResult(NamedTuple):
    pose: torch.Tensor        # [4,4] final increment estimate
    stats: IcpStats           # stats at the last evaluated linearization
    iterations: int


def _pack_model_image(model: Maps) -> torch.Tensor:
    """Loop-invariant flat model image [H*W, 8]: vertex 0:3, normal 3:6,
    valid 6, label 7."""
    return torch.cat([
        model.vertex.reshape(-1, 3),
        model.normal.reshape(-1, 3),
        model.valid.reshape(-1, 1).to(torch.float32),
        model.sem_label.reshape(-1, 1).to(torch.float32),
    ], dim=-1)


def _sample_model(model_img: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                  h: int, w: int, bilinear: bool):
    """(v_m, n_m, m_valid, m_label) at continuous image coordinates: nearest
    tap, or bilinear geometry (horizontal wrap, vertical clamp) with the
    nearest tap's label."""
    if not bilinear:
        xi = torch.clamp(u.to(torch.int64), 0, w - 1)
        yi = torch.clamp(v.to(torch.int64), 0, h - 1)
        g = model_img[yi * w + xi]
        n_m = g[..., 3:6]
        n_m = n_m / torch.clamp_min(
            torch.linalg.norm(n_m, dim=-1, keepdim=True), 1e-12)
        return g[..., 0:3], n_m, g[..., 6] > 0.5, g[..., 7].to(torch.int32)
    xf = u - 0.5
    yf = v - 0.5
    x0 = torch.floor(xf)
    y0 = torch.floor(yf)
    ax = (xf - x0)[..., None]
    ay = (yf - y0)[..., None]
    x0i = torch.remainder(x0.to(torch.int64), w)
    x1i = torch.remainder(x0i + 1, w)
    y0i = torch.clamp(y0.to(torch.int64), 0, h - 1)
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    g00 = model_img[y0i * w + x0i]
    g10 = model_img[y0i * w + x1i]
    g01 = model_img[y1i * w + x0i]
    g11 = model_img[y1i * w + x1i]
    top = g00 * (1 - ax) + g10 * ax
    bot = g01 * (1 - ax) + g11 * ax
    samp = top * (1 - ay) + bot * ay
    n_m_raw = samp[..., 3:6]
    m_valid = samp[..., 6] > 0.999  # all 4 taps valid
    n_m = n_m_raw / torch.clamp_min(
        torch.linalg.norm(n_m_raw, dim=-1, keepdim=True), 1e-12)
    right = ax[..., 0] > 0.5
    down = ay[..., 0] > 0.5
    lab_top = torch.where(right, g10[..., 7], g00[..., 7])
    lab_bot = torch.where(right, g11[..., 7], g01[..., 7])
    m_label = torch.where(down, lab_bot, lab_top).to(torch.int32)
    return samp[..., 0:3], n_m, m_valid, m_label


def _project_to_model(pts: torch.Tensor, model_cfg: DataConfig):
    """Continuous model-image coordinates of points."""
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    depth = torch.sqrt(x * x + y * y + z * z)
    yaw = torch.atan2(y, x)
    pitch = -torch.asin(torch.clamp(z / torch.clamp_min(depth, 1e-12),
                                    -1.0, 1.0))
    u = 0.5 * (-yaw * INV_PI + 1.0) * model_cfg.width
    v = (1.0 - (pitch * _DEG + model_cfg.fov_up) / model_cfg.fov) \
        * model_cfg.height
    return u, v


def build_rows(pose: torch.Tensor, data: Maps, model: Maps, icp: IcpConfig,
               model_cfg: DataConfig, iteration: int, semantic: bool = True,
               model_img: torch.Tensor | None = None):
    """Weighted Jacobian rows A [P, 8] and the per-pixel stats. Row layout:
    0:3 = sqrt(w) n_m, 3:6 = sqrt(w) (v_d x n_m), 6 = sqrt(w) r, 7 = 0; then
    A^T A[0:6,0:6] = J^T W J and A^T A[0:6,6] = J^T W f."""
    h, w = data.vertex.shape[:2]
    p = h * w
    v_data = data.vertex.reshape(p, 3)
    n_data = data.normal.reshape(p, 3)
    d_valid = (data.vertex_valid & data.normal_valid).reshape(p)

    r = pose[:3, :3]
    t = pose[:3, 3]
    v_d = v_data @ r.T + t
    n_d = n_data @ r.T

    u, v = _project_to_model(v_d, model_cfg)
    inside = (u >= 0) & (u < model_cfg.width) & (v >= 0) \
        & (v < model_cfg.height)

    if model_img is None:
        model_img = _pack_model_image(model)
    v_m, n_m, m_valid, m_label = _sample_model(
        model_img, u, v, model_cfg.height, model_cfg.width,
        icp.sampling == "bilinear")

    assoc = d_valid & inside & m_valid

    diff = v_d - v_m
    residual = torch.sum(n_m * diff, dim=-1)
    dist = torch.linalg.norm(diff, dim=-1)
    ndot = torch.sum(n_m * n_d, dim=-1)

    angle_thresh = math.cos(math.radians(icp.max_angle))
    inlier = assoc & (dist <= icp.max_distance) & (ndot >= angle_thresh)

    absr = torch.abs(residual)
    if icp.weighting == "huber":
        weight = torch.where(absr > icp.factor,
                             icp.factor / torch.clamp_min(absr, 1e-12), 1.0)
    elif icp.weighting == "turkey":
        alpha = residual / icp.factor
        turkey = torch.square(1.0 - alpha * alpha)
        weight = torch.where(absr > icp.factor, 0.0,
                             turkey if iteration > 0
                             else torch.ones_like(turkey))
    else:
        weight = torch.ones_like(residual)

    if semantic:
        d_label = data.sem_label.reshape(p)
        d_prob = data.sem_prob.reshape(p)
        movable = is_movable(m_label)
        agree = d_label == m_label
        sem_w = torch.where(movable, torch.where(agree, d_prob, 1.0 - d_prob),
                            1.0)
        weight = weight * sem_w

    cp = torch.linalg.cross(v_d, n_m, dim=-1)
    sw = torch.sqrt(torch.clamp_min(weight, 0.0))
    row_mask = inlier.to(torch.float32)[:, None]
    rows = torch.cat([sw[:, None] * n_m, sw[:, None] * cp,
                      (sw * residual)[:, None],
                      torch.zeros((p, 1), dtype=torch.float32,
                                  device=v_d.device)], dim=-1) * row_mask

    wr2 = weight * residual * residual
    stats = IcpStats(
        error=torch.sum(torch.where(assoc, wr2, 0.0)),
        valid=torch.sum(assoc).to(torch.int32),
        inlier=torch.sum(inlier).to(torch.int32),
        outlier=torch.sum(assoc & ~inlier).to(torch.int32),
        inlier_residual=torch.sum(torch.where(inlier, wr2, 0.0)),
        invalid=torch.sum(d_valid & ~assoc).to(torch.int32),
    )
    return rows, stats


def jacobian_products(pose: torch.Tensor, data: Maps, model: Maps,
                      icp: IcpConfig, model_cfg: DataConfig, iteration=0,
                      semantic: bool = True):
    """One linearization: (J^T W J [6,6], J^T W f [6], stats)."""
    rows, stats = build_rows(pose, data, model, icp, model_cfg, iteration,
                             semantic)
    ata = rows.T @ rows
    return ata[:6, :6], ata[:6, 6], stats


# calls of gauss_newton and the iterations they ran, since the process began
gn_counts = {"calls": 0, "iterations": 0}


def _solve_spd(jtj: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """6x6 SPD solve by Cholesky with a tiny Tikhonov floor; NaN where the
    factorization fails (as the JAX Cholesky does)."""
    eye = torch.eye(6, dtype=jtj.dtype, device=jtj.device)
    a = jtj + 1e-8 * eye * torch.clamp_min(torch.trace(jtj) / 6.0, 1.0)
    chol, info = torch.linalg.cholesky_ex(a)
    x = torch.cholesky_solve(rhs[:, None], chol)[:, 0]
    return torch.where(info == 0, x, torch.nan)


def _sum_over(group, ata: torch.Tensor, stats: IcpStats):
    """``ata`` and the statistics summed over the ranks of ``group`` in one
    all-reduce (the counts travel as float32, exact below 2^24)."""
    vec = group.sum(torch.cat([ata.reshape(-1), torch.stack(
        [s.to(torch.float32).reshape(()) for s in stats])]))
    n = ata.numel()
    summed = IcpStats(*(vec[n + j].to(s.dtype) if s.dtype.is_floating_point
                        else torch.round(vec[n + j]).to(s.dtype)
                        for j, s in enumerate(stats)))
    return vec[:n].reshape(ata.shape), summed


def gauss_newton(data: Maps, model: Maps, t0: torch.Tensor, icp: IcpConfig,
                 model_cfg: DataConfig, semantic: bool = True,
                 max_iterations: int | None = None,
                 group=None) -> IcpResult:
    """Gauss-Newton alignment. Stops on a minimal step (||delta||_inf <
    delta), a vanishing gradient, a converged error change, or a non-finite
    step, checked after applying the increment; at most ``max_iterations``
    (default ``icp.max_iterations``) linearizations. ``gn_counts`` counts the
    calls and their iterations for the run reports.

    ``group`` (a ``parallel.distributed.Group``): ``data`` holds this rank's
    rows only; ``A^T A`` and the statistics are summed over the ranks before
    the solve and the stopping test (the JAX package's ``psum`` over
    ``axis``)."""
    max_iter = icp.max_iterations if max_iterations is None else max_iterations
    model_img = _pack_model_image(model)
    pose = t0.to(torch.float32)
    last_err = torch.full((), torch.inf, dtype=torch.float32,
                          device=pose.device)
    stats = IcpStats(*(torch.zeros((), dtype=dt, device=pose.device)
                       for dt in (torch.float32, torch.int32, torch.int32,
                                  torch.int32, torch.float32, torch.int32)))
    k = 0
    done = False
    while k < max_iter and not done:
        rows, stats = build_rows(pose, data, model, icp, model_cfg, k,
                                 semantic, model_img=model_img)
        ata = rows.T @ rows
        if group is not None:
            ata, stats = _sum_over(group, ata, stats)
        jtj, jtf = ata[:6, :6], ata[:6, 6]
        delta = _solve_spd(jtj, -jtf)
        err = stats.error
        finite = torch.all(torch.isfinite(delta))
        stop = (torch.max(torch.abs(delta)) < icp.delta) \
            | (torch.abs(torch.max(jtf)) < icp.stopping_threshold) \
            | ((err < last_err)
               & (torch.abs(err - last_err) < icp.stopping_threshold)) \
            | ~finite
        new_pose = lie.se3_exp(torch.nan_to_num(delta)) @ pose
        pose = torch.where(finite, new_pose, pose)
        last_err = err
        k += 1
        done = to_host(stop)
    gn_counts["calls"] += 1
    gn_counts["iterations"] += k
    return IcpResult(pose=pose, stats=stats, iterations=k)


def evaluate(pose: torch.Tensor, data: Maps, model: Maps, icp: IcpConfig,
             model_cfg: DataConfig, semantic: bool = True) -> IcpStats:
    """Residual statistics at a fixed pose (loop-closure verification): one
    linearization, returned as device tensors with no host read."""
    _, stats = build_rows(pose, data, model, icp, model_cfg, 0, semantic)
    return stats

