"""Spherical range-image projection (counterpart of
``semantic_suma_tpu/ops/projection.py``): each point maps to a (yaw, pitch)
pixel and the nearest point per pixel wins through the z-buffer kernel."""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..config import DataConfig
from .zbuffer import gather_or, scatter_reduce_sum, zbuffer_argmin

INV_PI = 0.3183098861837907
_DEG = 180.0 / math.pi
_RAD = math.pi / 180.0


class ProjectionResult(NamedTuple):
    vertex_map: torch.Tensor    # [H, W, 3] xyz of winning point
    vertex_valid: torch.Tensor  # [H, W] bool
    depth_map: torch.Tensor     # [H, W] range (inf where empty)
    sem_label: torch.Tensor     # [H, W] int32
    sem_prob: torch.Tensor      # [H, W] float32
    remission: torch.Tensor     # [H, W] float32
    point_px: torch.Tensor      # [N] int32 x pixel per point (-1 invalid)
    point_py: torch.Tensor      # [N] int32 y pixel per point


def spherical_pixel(points: torch.Tensor, cfg: DataConfig):
    """Integer pixel coordinates + depth of 3D points. Returns
    (px, py, depth, inside): columns wrap (clamped boundary texel), rows and
    depth outside the sensor's range are outside."""
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    depth = torch.sqrt(x * x + y * y + z * z)
    safe = torch.clamp_min(depth, 1e-12)
    yaw = torch.atan2(y, x)
    pitch = -torch.asin(torch.clamp(z / safe, -1.0, 1.0))

    x01 = 0.5 * (-yaw * INV_PI + 1.0)
    y01 = 1.0 - (pitch * _DEG + cfg.fov_up) / cfg.fov

    px = torch.floor(x01 * cfg.width).to(torch.int32)
    px = torch.clamp(px, 0, cfg.width - 1)
    py_f = torch.floor(y01 * cfg.height)
    py = torch.clamp(py_f, 0, cfg.height - 1).to(torch.int32)

    inside = ((depth >= cfg.min_depth) & (depth <= cfg.max_depth)
              & (py_f >= 0) & (py_f < cfg.height))
    return px, py, depth, inside


def pixel_rays(cfg: DataConfig, device=None,
               dtype=torch.float32) -> torch.Tensor:
    """Unit view ray through each pixel center: [H, W, 3]."""
    xs = (torch.arange(cfg.width, dtype=dtype, device=device) + 0.5) / cfg.width
    ys = (torch.arange(cfg.height, dtype=dtype, device=device) + 0.5) \
        / cfg.height
    yaw = -(2.0 * xs - 1.0) * math.pi
    pitch = ((1.0 - ys) * cfg.fov - cfg.fov_up) * _RAD
    cp = torch.cos(pitch)[:, None]
    sp = torch.sin(pitch)[:, None]
    cy = torch.cos(yaw)[None, :]
    sy = torch.sin(yaw)[None, :]
    return torch.stack([cp * cy, cp * sy, -sp * torch.ones_like(cy)], dim=-1)


def project_scan(points: torch.Tensor,
                 labels: Optional[torch.Tensor] = None,
                 probs: Optional[torch.Tensor] = None,
                 remissions: Optional[torch.Tensor] = None,
                 *,
                 cfg: DataConfig,
                 point_valid: Optional[torch.Tensor] = None,
                 averaging: bool = False) -> ProjectionResult:
    """Vertex/semantic maps from a raw scan [N, 3] (nearest point per pixel,
    or blend-averaged geometry with ``averaging``)."""
    n = points.shape[0]
    dev = points.device
    h, w = cfg.height, cfg.width
    px, py, depth, inside = spherical_pixel(points, cfg)
    if point_valid is not None:
        inside = inside & point_valid
    ids = torch.where(inside, py.to(torch.int64) * w + px, -1)
    bound = max(100.0, cfg.max_depth)

    if averaging:
        ones = torch.where(inside, 1.0, 0.0)
        sums = scatter_reduce_sum(ids, points, h * w)
        cnt = scatter_reduce_sum(ids, ones, h * w)
        have = cnt > 0
        vertex = torch.where(have[:, None],
                             sums / torch.clamp_min(cnt, 1.0)[:, None], 0.0)
        vmap = vertex.reshape(h, w, 3)
        vvalid = have.reshape(h, w)
        dmap = torch.where(vvalid, torch.linalg.norm(vmap, dim=-1), torch.inf)
        winner, _ = zbuffer_argmin(ids, depth, h * w, depth_bound=bound)
    else:
        winner, wdepth = zbuffer_argmin(ids, depth, h * w, depth_bound=bound)
        vmap = gather_or(winner, points, 0.0).reshape(h, w, 3)
        vvalid = (winner >= 0).reshape(h, w)
        dmap = wdepth.reshape(h, w)

    if labels is None:
        labels = torch.zeros((n,), dtype=torch.int32, device=dev)
    if probs is None:
        probs = torch.ones((n,), dtype=torch.float32, device=dev)
    if remissions is None:
        remissions = torch.zeros((n,), dtype=torch.float32, device=dev)

    sem_label = gather_or(winner, labels.to(torch.int32), 0).reshape(h, w)
    sem_prob = gather_or(winner, probs.to(torch.float32), 0.0).reshape(h, w)
    rem = gather_or(winner, remissions.to(torch.float32), 0.0).reshape(h, w)

    return ProjectionResult(vmap, vvalid, dmap, sem_label, sem_prob, rem,
                            torch.where(inside, px, -1),
                            torch.where(inside, py, -1))
