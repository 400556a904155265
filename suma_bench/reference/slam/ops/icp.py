"""Frame-to-model projective ICP, plain: weighted Jacobian rows, their
products per linearization, and the Gauss-Newton loop (the port's
``ops/icp.py`` with kernels D, E and F replaced by their plain versions).

The loop's state (:func:`gn_state`) lives in two small tensors; each
iteration builds the rows (:func:`build_rows`), sums ``rows.T @ rows``,
solves, runs the stop test and updates the pose, and nothing changes once
``done`` is set (the port's latch). :func:`evaluate` is the loop's first
iteration.

Twist convention ``x = [v, omega]``, increment applied on the left:
``pose <- exp(x) @ pose``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..config import DataConfig, IcpConfig
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
    iterations: torch.Tensor  # int32


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
               model_cfg: DataConfig, iteration, semantic: bool = True,
               model_img: torch.Tensor | None = None):
    """Weighted Jacobian rows A [P, 8] and the per-pixel stats
    (``iteration``: an int, or a 0-dim device tensor). Row layout:
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
        if isinstance(iteration, torch.Tensor):  # a device counter: no read
            turkey = torch.where(iteration > 0, turkey, 1.0)
        elif iteration <= 0:
            turkey = torch.ones_like(turkey)
        weight = torch.where(absr > icp.factor, 0.0, turkey)
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


def _solve_spd(jtj: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """6x6 SPD solve by Cholesky with a tiny Tikhonov floor; NaN where the
    factorization fails (as the JAX Cholesky does)."""
    eye = torch.eye(6, dtype=jtj.dtype, device=jtj.device)
    a = jtj + 1e-8 * eye * torch.clamp_min(torch.trace(jtj) / 6.0, 1.0)
    chol, info = torch.linalg.cholesky_ex(a)
    x = torch.cholesky_solve(rhs[:, None], chol)[:, 0]
    return torch.where(info == 0, x, torch.nan)


# --- the loop's state and one iteration's two halves ----------------------

# One linearization's sums: the lower triangle of A^T A[0:6, 0:6] by rows
# (21), A^T A[0:6, 6] (6), then error, inlier_residual, valid, inlier,
# outlier, invalid (the counts as float32, exact below 2^24).
NPART = 33
_NTRI = 21
# state_f [20] float32: pose [0:16], last_err 16, error 17,
# inlier_residual 18; state_i [8] int32: k 0, done 1, valid 2, inlier 3,
# outlier 4, invalid 5
_SF, _SI = 20, 8


def gn_state(t0: torch.Tensor, k=0):
    """The loop's state ``(state_f, state_i)`` at pose ``t0``: last_err
    +inf, iteration ``k``, not done, statistics 0."""
    dev = t0.device
    state_f = torch.zeros(_SF, dtype=torch.float32, device=dev)
    state_f[:16].copy_(t0.to(torch.float32).reshape(-1))
    state_f[16:17].fill_(math.inf)
    state_i = torch.zeros(_SI, dtype=torch.int32, device=dev)
    state_i[0:1].fill_(k)
    return state_f, state_i


def gn_result(state_f: torch.Tensor, state_i: torch.Tensor) -> IcpResult:
    """The loop's result as views of its state: the pose, the statistics of
    the last live linearization and the iterations."""
    return IcpResult(
        pose=state_f[:16].view(4, 4),
        stats=IcpStats(error=state_f[17], valid=state_i[2],
                       inlier=state_i[3], outlier=state_i[4],
                       inlier_residual=state_f[18], invalid=state_i[5]),
        iterations=state_i[0])


def _pack_products(ata: torch.Tensor, stats: IcpStats) -> torch.Tensor:
    """``A^T A`` [8, 8] and the statistics -> one ``[1, NPART]`` row."""
    il = torch.tril_indices(6, 6, device=ata.device)
    counts = torch.stack([stats.valid, stats.inlier, stats.outlier,
                          stats.invalid]).to(torch.float32)
    return torch.cat([ata[il[0], il[1]], ata[:6, 6],
                      torch.stack([stats.error, stats.inlier_residual]),
                      counts])[None]


def icp_products(state_f: torch.Tensor, state_i: torch.Tensor,
                 data: Maps, model_img: torch.Tensor, icp: IcpConfig,
                 model_cfg: DataConfig, semantic: bool = True) -> torch.Tensor:
    """One linearization: :func:`build_rows` at the state's pose and
    iteration and ``rows.T @ rows``, as one ``[1, NPART]`` row."""
    rows, stats = build_rows(state_f[:16].view(4, 4), data, None, icp,
                             model_cfg, state_i[0], semantic,
                             model_img=model_img)
    return _pack_products(rows.T @ rows, stats)


def gn_update(partials: torch.Tensor, state_f: torch.Tensor,
              state_i: torch.Tensor, icp: IcpConfig) -> None:
    """In place on the state: the partial sums summed (in float64), the
    solve, the stop test and the pose update of the JAX loop's body; nothing
    changes once ``done`` is set."""
    tot = partials.to(torch.float64).sum(0).to(torch.float32)
    il = torch.tril_indices(6, 6, device=tot.device)
    low = torch.zeros((6, 6), dtype=torch.float32, device=tot.device)
    low[il[0], il[1]] = tot[:_NTRI]
    jtj = low + torch.tril(low, -1).T
    jtf = tot[_NTRI:_NTRI + 6]
    err = tot[27]
    counts = torch.round(tot[29:33]).to(torch.int32)
    delta = _solve_spd(jtj, -jtf)
    last_err = state_f[16]
    finite = torch.all(torch.isfinite(delta))
    stop = (torch.max(torch.abs(delta)) < icp.delta) \
        | (torch.abs(torch.max(jtf)) < icp.stopping_threshold) \
        | ((err < last_err)
           & (torch.abs(err - last_err) < icp.stopping_threshold)) \
        | ~finite
    pose = state_f[:16].view(4, 4)
    new_pose = lie.se3_exp(torch.nan_to_num(delta)) @ pose
    new_f = torch.cat([torch.where(finite, new_pose, pose).reshape(-1),
                       torch.stack([err, err, tot[28]]), state_f[19:]])
    new_i = torch.cat([(state_i[0] + 1).reshape(1),
                       stop.to(torch.int32).reshape(1), counts,
                       state_i[6:]])
    live = state_i[1] == 0
    state_f.copy_(torch.where(live, new_f, state_f))
    state_i.copy_(torch.where(live, new_i, state_i))


def gn_loop(state_f: torch.Tensor, state_i: torch.Tensor, data: Maps,
            model_img: torch.Tensor, icp: IcpConfig, model_cfg: DataConfig,
            semantic: bool = True, max_iterations: int | None = None) -> None:
    """Up to ``max_iterations`` (default ``icp.max_iterations``) trips of
    :func:`icp_products` and :func:`gn_update` on the state, in place,
    ending at the latch (a read of ``done`` a trip)."""
    if max_iterations is None:
        max_iterations = icp.max_iterations
    for _ in range(int(max_iterations)):
        if bool(state_i[1]):
            break
        row = icp_products(state_f, state_i, data, model_img, icp,
                           model_cfg, semantic)
        gn_update(row, state_f, state_i, icp)


def gauss_newton(data: Maps, model: Maps, t0: torch.Tensor, icp: IcpConfig,
                 model_cfg: DataConfig, semantic: bool = True,
                 max_iterations: int | None = None) -> IcpResult:
    """Gauss-Newton alignment. Stops on a minimal step (||delta||_inf <
    delta), a vanishing gradient, a converged error change, or a non-finite
    step, checked after applying the increment; at most ``max_iterations``
    (default ``icp.max_iterations``) linearizations."""
    state_f, state_i = gn_state(t0)
    gn_loop(state_f, state_i, data, _pack_model_image(model), icp, model_cfg,
            semantic, max_iterations)
    return gn_result(state_f, state_i)


def evaluate(pose: torch.Tensor, data: Maps, model: Maps, icp: IcpConfig,
             model_cfg: DataConfig, semantic: bool = True) -> IcpStats:
    """Residual statistics at a fixed pose (loop-closure verification): the
    loop's first iteration, whose update writes the statistics of the
    linearization it consumed into the state."""
    state_f, state_i = gn_state(pose)
    gn_loop(state_f, state_i, data, _pack_model_image(model), icp, model_cfg,
            semantic, 1)
    return gn_result(state_f, state_i).stats
