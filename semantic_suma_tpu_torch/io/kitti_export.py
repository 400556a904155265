"""Write a synthetic scan sequence in the KITTI odometry layout
(counterpart of ``semantic_suma_tpu/io/kitti_export.py``), so that the file
path (``KITTIReader``, ``calib.txt``, camera-frame pose export, the devkit
evaluation) runs end to end without KITTI data:

    <out>/velodyne/000000.bin   Nx4 float32 (x, y, z, remission)
    <out>/labels/000000.label   N uint32 (low 16 bits = semantic id)
    <out>/calib.txt             P0..P3 + Tr (velodyne->camera)
    <out>/poses.txt             ground-truth poses, camera frame, 3x4 rows

``Tr`` is a non-trivial velodyne->camera transform (an axis permutation
like the KITTI rigs), so the ``Tr @ P @ Tr^-1`` round trip is exercised.
"""

from __future__ import annotations

import os

import numpy as np

from .kitti import save_poses
from .simulation import SimulationReader, default_world

# A KITTI-like velodyne->camera extrinsic: camera x=right(-y_velo),
# y=down(-z_velo), z=forward(x_velo), plus a small lever arm.
DEFAULT_TR = np.array([
    [0.0, -1.0, 0.0, -0.01],
    [0.0, 0.0, -1.0, -0.05],
    [1.0, 0.0, 0.0, -0.29],
    [0.0, 0.0, 0.0, 1.0]], dtype=np.float64)


def write_calib(path: str, tr: np.ndarray = DEFAULT_TR) -> None:
    p = np.zeros((3, 4))
    p[:3, :3] = np.diag([718.856, 718.856, 1.0])
    p[0, 2], p[1, 2] = 607.19, 185.22
    with open(path, "w") as f:
        for name in ("P0", "P1", "P2", "P3"):
            f.write(name + ": " + " ".join(f"{v:.12e}"
                                           for v in p.reshape(-1)) + "\n")
        f.write("Tr: " + " ".join(f"{v:.12e}"
                                  for v in tr[:3, :4].reshape(-1)) + "\n")


def export_scan(vel_path: str, label_path: str, points: np.ndarray,
                remissions: np.ndarray, labels: np.ndarray,
                valid: np.ndarray | None = None) -> None:
    """One scan -> velodyne ``.bin`` + SemanticKITTI ``.label`` (valid rows
    only)."""
    points = np.asarray(points, np.float32)
    remissions = np.asarray(remissions, np.float32)
    labels = np.asarray(labels).astype(np.uint32)
    if valid is not None:
        keep = np.asarray(valid).astype(bool)
        points, remissions, labels = points[keep], remissions[keep], \
            labels[keep]
    raw = np.concatenate([points, remissions[:, None]], axis=1)
    raw.astype(np.float32).tofile(vel_path)
    (labels & np.uint32(0xFFFF)).astype(np.uint32).tofile(label_path)


def export_synthetic_sequence(out_dir: str, n_scans: int, data_cfg,
                              world=None, radius: float = 18.0,
                              step: float | None = None,
                              noise_sigma: float = 0.0, seed: int = 0,
                              tr: np.ndarray = DEFAULT_TR,
                              device=None) -> np.ndarray:
    """Raycast ``n_scans`` synthetic scans on ``device`` (the card unless
    the caller names another) and write a complete KITTI sequence
    directory. Returns the ground-truth poses (velodyne frame, float64)."""
    os.makedirs(os.path.join(out_dir, "velodyne"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "labels"), exist_ok=True)
    reader = SimulationReader(data_cfg, n_scans=n_scans,
                              world=world or default_world(seed=seed),
                              radius=radius, noise_sigma=noise_sigma,
                              seed=seed, step=step, device=device)
    for i in range(n_scans):
        s = reader.read(i)
        valid = s.valid.cpu().numpy()
        # remission 0.5 everywhere valid: the reader max-normalizes, so any
        # constant survives the round trip
        rem = np.where(valid, 0.5, 0.0).astype(np.float32)
        export_scan(os.path.join(out_dir, "velodyne", f"{i:06d}.bin"),
                    os.path.join(out_dir, "labels", f"{i:06d}.label"),
                    s.points.cpu().numpy(), rem, s.labels.cpu().numpy(),
                    valid)
    write_calib(os.path.join(out_dir, "calib.txt"), tr)
    gt = reader.poses.cpu().numpy().astype(np.float64)
    save_poses(os.path.join(out_dir, "poses.txt"), gt, tr)
    return gt
