"""Synthetic LiDAR world: an analytic raycaster with exact ground-truth poses
(counterpart of ``semantic_suma_tpu/io/simulation.py``): a ground plane plus
labeled axis-aligned boxes, one ray per range-image pixel, optional Gaussian
range noise from a ``torch.Generator``."""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..config import DataConfig
from ..device import resolve_device
from ..ops.projection import pixel_rays


@dataclass(frozen=True)
class Box:
    center: tuple
    size: tuple          # full extents
    label: int = 50      # SemanticKITTI id (50 = building)


@dataclass(frozen=True)
class World:
    """Ground plane at z = ground_z plus labeled boxes."""

    boxes: tuple = ()
    ground_z: float = -1.8
    ground_label: int = 40  # road


def default_world(seed: int = 0, n_boxes: int = 24, extent: float = 45.0,
                  movable_fraction: float = 0.0) -> World:
    """A ring of buildings around the trajectory; optionally some 'cars'."""
    rng = np.random.default_rng(seed)
    boxes = []
    for i in range(n_boxes):
        ang = 2 * np.pi * i / n_boxes + rng.uniform(-0.1, 0.1)
        rad = extent * rng.uniform(0.75, 1.0)
        cx, cy = rad * np.cos(ang), rad * np.sin(ang)
        sx, sy = rng.uniform(4, 12), rng.uniform(4, 12)
        sz = rng.uniform(4, 10)
        label = 10 if rng.uniform() < movable_fraction else 50
        boxes.append(Box((float(cx), float(cy), float(sz / 2 - 1.8)),
                         (float(sx), float(sy), float(sz)), label))
    for i in range(6):  # nearby structure inside the ring
        ang = 2 * np.pi * i / 6 + 0.4
        rad = extent * 0.45
        boxes.append(Box((float(rad * np.cos(ang)), float(rad * np.sin(ang)),
                          0.2), (3.0, 3.0, 4.0), 50))
    return World(boxes=tuple(boxes))


def rich_world() -> World:
    """The world of the forced-spill circle (``tests/test_spill.py``): two
    rings of boxes (8 m and 24 m) flanking the 16 m circle, so that a 12 m
    sensor always has structure to track."""
    rng = np.random.default_rng(1)
    boxes = []
    for ring_r, nb in ((8.0, 8), (24.0, 16)):
        for i in range(nb):
            a = 2 * np.pi * i / nb + rng.uniform(-0.15, 0.15)
            sz = float(rng.uniform(3.5, 6.0))
            boxes.append(Box((float(ring_r * np.cos(a)),
                              float(ring_r * np.sin(a)), float(sz / 2 - 1.8)),
                             (2.5, 2.5, sz), 50))
    return World(boxes=tuple(boxes))


class SimScan(NamedTuple):
    points: torch.Tensor      # [N, 3] sensor frame
    labels: torch.Tensor      # [N] int32
    probs: torch.Tensor       # [N] float32
    remissions: torch.Tensor  # [N] float32
    valid: torch.Tensor       # [N] bool (ray hit something in range)


def _ray_plane(origin, dirs, z0):
    """Distance along dirs to plane z=z0 (inf if parallel/behind)."""
    dz = dirs[..., 2]
    t = (z0 - origin[2]) / torch.where(torch.abs(dz) < 1e-9, torch.inf, dz)
    return torch.where(t > 0, t, torch.inf)


def _ray_box(origin, dirs, lo, hi):
    """Slab-method ray/AABB intersection distance (inf on miss)."""
    inv = 1.0 / torch.where(torch.abs(dirs) < 1e-12,
                            torch.where(dirs >= 0, 1e-12, -1e-12), dirs)
    t0 = (lo - origin) * inv
    t1 = (hi - origin) * inv
    tmin = torch.amax(torch.minimum(t0, t1), dim=-1)
    tmax = torch.amin(torch.maximum(t0, t1), dim=-1)
    hit = (tmax >= tmin) & (tmax > 0)
    t = torch.where(tmin > 0, tmin, tmax)
    return torch.where(hit, t, torch.inf)


def render_scan(world: World, pose: torch.Tensor, cfg: DataConfig,
                noise_sigma: float = 0.0,
                generator: torch.Generator | None = None) -> SimScan:
    """Raycast one scan from a sensor pose (sensor->world [4,4]). Points are in
    the SENSOR frame, flattened in pixel row-major order."""
    dev = pose.device
    rays_s = pixel_rays(cfg, device=dev).reshape(-1, 3)
    r = pose[:3, :3]
    origin = pose[:3, 3]
    rays_w = rays_s @ r.T

    t_best = _ray_plane(origin, rays_w, world.ground_z)
    label = torch.where(torch.isfinite(t_best), world.ground_label, 0) \
        .to(torch.int32)
    for box in world.boxes:
        c = torch.tensor(box.center, dtype=torch.float32, device=dev)
        s = torch.tensor(box.size, dtype=torch.float32, device=dev) / 2.0
        t_box = _ray_box(origin, rays_w, c - s, c + s)
        closer = t_box < t_best
        t_best = torch.minimum(t_best, t_box)
        label = torch.where(closer, box.label, label).to(torch.int32)

    if noise_sigma > 0.0 and generator is not None:
        t_best = t_best + noise_sigma * torch.randn(
            t_best.shape, generator=generator, device=dev)

    valid = torch.isfinite(t_best) & (t_best >= cfg.min_depth) \
        & (t_best <= cfg.max_depth)
    t_safe = torch.where(valid, t_best, 1.0)
    pts = rays_s * t_safe[:, None]
    return SimScan(points=torch.where(valid[:, None], pts, 0.0),
                   labels=torch.where(valid, label, 0).to(torch.int32),
                   probs=torch.where(valid, 0.95, 0.0).to(torch.float32),
                   remissions=torch.zeros_like(t_safe),
                   valid=valid)


def circular_trajectory(n: int, radius: float = 18.0, height: float = 0.0,
                        step: float | None = None, device=None,
                        dtype=torch.float32) -> torch.Tensor:
    """[N,4,4] poses driving a circle, x-axis along the motion direction.
    ``step`` fixes the arc length per scan; by default the N poses cover one
    revolution."""
    if step is None:
        ang = 2 * np.pi * np.arange(n) / n
    else:
        ang = (step / radius) * np.arange(n)
    poses = []
    for a in ang:
        cy, sy = np.cos(a + np.pi / 2), np.sin(a + np.pi / 2)
        m = np.eye(4)
        m[:3, :3] = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
        m[:3, 3] = [radius * np.cos(a), radius * np.sin(a), height]
        poses.append(m)
    return torch.as_tensor(np.stack(poses), dtype=dtype, device=device)


class SimulationReader:
    """Scan reader over the raycaster (read/count/seek contract)."""

    def __init__(self, cfg: DataConfig, n_scans: int = 100,
                 world: World | None = None, radius: float = 18.0,
                 noise_sigma: float = 0.0, seed: int = 0,
                 step: float | None = None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.world = world if world is not None else default_world(seed)
        self.poses = circular_trajectory(n_scans, radius, step=step,
                                         device=self.device)
        self.noise_sigma = noise_sigma
        self.seed = seed
        self._n = n_scans

    def count(self) -> int:
        return self._n

    def is_seekable(self) -> bool:
        return True

    def read(self, idx: int) -> SimScan:
        gen = None
        if self.noise_sigma > 0.0:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self.seed * 1_000_003 + idx)
        return render_scan(self.world, self.poses[idx], self.cfg,
                           self.noise_sigma, gen)

    def gt_pose(self, idx: int) -> torch.Tensor:
        return self.poses[idx]
