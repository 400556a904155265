"""The benchmark's scan generator: a frozen copy of the port's synthetic
LiDAR world (``io/simulation.py``: the analytic ray caster, ``default_world``
and ``circular_trajectory``, with ``ops/projection.pixel_rays``), so that a
later change to the port's copy cannot move the traffic.

A world is a ground plane plus labelled axis-aligned boxes; one ray is cast
from a sensor pose for each of the sensor's rings and columns (an HDL-64E
casts 64 x ~2,048 a revolution, finer than the SLAM's range image, so that
several points fall on one pixel), with Gaussian range noise, on the device
the pose is on. A sequence is a stack of scans rendered from consecutive
poses."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch


@dataclass(frozen=True)
class Box:
    center: tuple
    size: tuple          # full extents
    label: int = 50      # SemanticKITTI id (50 = building)


@dataclass(frozen=True)
class World:
    """Ground plane at z = ground_z plus labelled boxes."""

    boxes: tuple = ()
    ground_z: float = -1.8
    ground_label: int = 40  # road


def default_world(seed: int = 0, n_boxes: int = 24, extent: float = 45.0,
                  movable_fraction: float = 0.0) -> World:
    """A ring of buildings around the trajectory; optionally some 'cars'
    (label 10) among them. The layout is drawn from ``seed``."""
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


class SimScan(NamedTuple):
    points: torch.Tensor      # [N, 3] sensor frame
    labels: torch.Tensor      # [N] int32
    probs: torch.Tensor       # [N] float32
    remissions: torch.Tensor  # [N] float32
    valid: torch.Tensor       # [N] bool (ray hit something in range)


def pixel_rays(height: int, width: int, fov_up: float, fov_down: float,
               device=None) -> torch.Tensor:
    """Unit view ray through each pixel centre: [H, W, 3]."""
    fov = abs(fov_up) + abs(fov_down)
    xs = (torch.arange(width, dtype=torch.float32, device=device) + 0.5) \
        / width
    ys = (torch.arange(height, dtype=torch.float32, device=device) + 0.5) \
        / height
    yaw = -(2.0 * xs - 1.0) * math.pi
    pitch = ((1.0 - ys) * fov - fov_up) * (math.pi / 180.0)
    cp = torch.cos(pitch)[:, None]
    sp = torch.sin(pitch)[:, None]
    cy = torch.cos(yaw)[None, :]
    sy = torch.sin(yaw)[None, :]
    return torch.stack([cp * cy, cp * sy, -sp * torch.ones_like(cy)], dim=-1)


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


def render_scan(world: World, pose: torch.Tensor, data: dict,
                noise_sigma: float = 0.0,
                generator: torch.Generator | None = None,
                columns: int | None = None) -> SimScan:
    """Raycast one scan from a sensor pose (sensor->world [4,4]): one ray
    for each of ``data["height"]`` rings and ``columns`` (``data["width"]``
    by default) azimuths, inside ``data``'s ``fov_up``/``fov_down``, kept
    between ``min_depth`` and ``max_depth``. Points are in the SENSOR frame,
    flattened ring by ring."""
    dev = pose.device
    rays_s = pixel_rays(data["height"], columns or data["width"],
                        data["fov_up"], data["fov_down"],
                        device=dev).reshape(-1, 3)
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

    valid = torch.isfinite(t_best) & (t_best >= data["min_depth"]) \
        & (t_best <= data["max_depth"])
    t_safe = torch.where(valid, t_best, 1.0)
    pts = rays_s * t_safe[:, None]
    return SimScan(points=torch.where(valid[:, None], pts, 0.0),
                   labels=torch.where(valid, label, 0).to(torch.int32),
                   probs=torch.where(valid, 0.95, 0.0).to(torch.float32),
                   remissions=torch.zeros_like(t_safe),
                   valid=valid)


def circular_trajectory(n: int, radius: float = 18.0, height: float = 0.0,
                        step: float | None = None, device=None) -> torch.Tensor:
    """[N,4,4] float32 poses driving a circle, x-axis along the motion
    direction. ``step`` fixes the arc length per scan; by default the N
    poses cover one revolution."""
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
    return torch.as_tensor(np.stack(poses), dtype=torch.float32,
                           device=device)


def render_sequence(traffic: dict, data: dict, sensor: dict, seed: int,
                    device):
    """The traffic mix's sequence from ``seed``: ``(scans, ground truth
    poses [N, 4, 4] numpy)``. ``traffic["world"]`` holds
    ``default_world``'s keywords (the layout is drawn from the seed),
    ``traffic["trajectory"]`` ``circular_trajectory``'s; ``sensor`` (the
    configuration's) its ``rings``, ``columns`` and ``range_noise_m``, the
    standard deviation of the range noise (drawn on the device from a
    generator seeded from the seed and the scan index). ``data`` gives the
    field of view and the depths kept."""
    world = default_world(seed=seed % 2**32, **traffic["world"])
    traj = traffic["trajectory"]
    gt = circular_trajectory(traj["n"], traj["radius"], step=traj["step"],
                             device=device)
    sigma = float(sensor["range_noise_m"])
    rings = dict(data, height=int(sensor["rings"]))
    scans = []
    for i in range(traj["n"]):
        gen = None
        if sigma > 0.0:
            gen = torch.Generator(device=device)
            gen.manual_seed((seed * 1_000_003 + i) % 2**63)
        scans.append(render_scan(world, gt[i], rings, sigma, gen,
                                 int(sensor["columns"])))
    return scans, gt.cpu().numpy().astype(np.float64)
