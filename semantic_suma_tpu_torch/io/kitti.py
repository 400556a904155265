"""KITTI odometry dataset I/O: velodyne scans, SemanticKITTI labels,
calibration and poses (counterpart of ``semantic_suma_tpu/io/kitti.py``).

Host numpy (a segmenter's tensors aside); ``SurfelSLAM`` moves a scan to
its device when it is dispatched. The reader parses the ``.bin`` files with
the native prefetching loader (``io/native_io``, built with ``g++`` at first
use; a failed build raises) or, with ``prefetch=False``, with numpy.
Labels come from SemanticKITTI ``.label`` files, from a ``segmenter`` callable
``(points, remissions) -> (labels, probs)`` (tensors it returns are passed
on as they are, on their device), or are absent (geometry only).
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch


class KittiScan(NamedTuple):
    """A scan; ``labels`` and ``probs`` are tensors on the segmenter's
    device when a segmenter that returns tensors labelled it."""
    points: np.ndarray      # [N, 3] float32
    remissions: np.ndarray  # [N] float32 (max-normalized)
    labels: np.ndarray      # [N] int32 raw SemanticKITTI ids (0 if none)
    probs: np.ndarray       # [N] float32


def read_bin(path: str) -> tuple[np.ndarray, np.ndarray]:
    """One KITTI velodyne ``.bin``: Nx4 float32 (x, y, z, remission); the
    remissions are normalized by their maximum."""
    raw = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    points = raw[:, :3]
    rem = raw[:, 3]
    m = rem.max()
    if m > 0:
        rem = rem / m
    return points, rem


def read_label(path: str) -> np.ndarray:
    """SemanticKITTI ``.label``: uint32 per point, low 16 bits = semantic
    id."""
    raw = np.fromfile(path, dtype=np.uint32)
    return (raw & 0xFFFF).astype(np.int32)


def parse_calib(path: str) -> dict[str, np.ndarray]:
    """``calib.txt``: name -> 4x4 matrix from its 12 row-major values."""
    out = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            name, vals = line.split(":", 1)
            nums = np.array(vals.split(), dtype=np.float64)
            m = np.eye(4)
            m[:3, :4] = nums[:12].reshape(3, 4)
            out[name.strip()] = m
    return out


def load_poses(path: str, tr: Optional[np.ndarray] = None) -> np.ndarray:
    """KITTI poses (camera frame, 3x4 rows) as [N, 4, 4] float64. With
    ``tr`` (the velodyne->camera calibration ``Tr``) they are converted to
    the velodyne frame, ``Tr^-1 @ P @ Tr``."""
    rows = np.loadtxt(path, dtype=np.float64).reshape(-1, 3, 4)
    poses = np.tile(np.eye(4), (rows.shape[0], 1, 1))
    poses[:, :3, :4] = rows
    if tr is not None:
        tr_inv = np.linalg.inv(tr)
        poses = np.einsum("ij,njk,kl->nil", tr_inv, poses, tr)
    return poses


def save_poses(path: str, poses: np.ndarray,
               tr: Optional[np.ndarray] = None) -> None:
    """Write poses in the KITTI camera-frame convention ``Tr @ P @ Tr^-1``
    as 3x4 text rows."""
    poses = np.asarray(poses, np.float64)
    if tr is not None:
        tr_inv = np.linalg.inv(tr)
        poses = np.einsum("ij,njk,kl->nil", tr, poses, tr_inv)
    with open(path, "w") as f:
        for p in poses:
            f.write(" ".join(f"{v:.9e}" for v in p[:3, :4].reshape(-1)) + "\n")


class KITTIReader:
    """Sequence reader (read/count/seek contract).

    Directory layout (KITTI odometry / SemanticKITTI):
      <seq>/velodyne/000000.bin ...
      <seq>/labels/000000.label ...      (optional, SemanticKITTI labels)
      <seq>/calib.txt                     (optional)
      <seq>/../poses/<NN>.txt or <seq>/poses.txt (optional ground truth)
    """

    def __init__(self, seq_dir: str, segmenter=None,
                 use_gt_labels: bool = True, prefetch: bool = True):
        self.seq_dir = seq_dir
        vel = os.path.join(seq_dir, "velodyne")
        if not os.path.isdir(vel):
            vel = seq_dir  # a directory of .bin files itself
        self.files = sorted(
            os.path.join(vel, f) for f in os.listdir(vel)
            if f.endswith(".bin"))
        if not self.files:
            raise FileNotFoundError(f"no .bin scans under {seq_dir}")

        lab = os.path.join(seq_dir, "labels")
        self.label_files = None
        if use_gt_labels and os.path.isdir(lab):
            lf = sorted(os.path.join(lab, f) for f in os.listdir(lab)
                        if f.endswith(".label"))
            if len(lf) == len(self.files):
                self.label_files = lf
        self.segmenter = segmenter

        self.calib = None
        calib_path = os.path.join(seq_dir, "calib.txt")
        if os.path.isfile(calib_path):
            self.calib = parse_calib(calib_path)

        self._native = None
        if prefetch:
            from .native_io import NativeScanLoader
            self._native = NativeScanLoader(self.files)

    def count(self) -> int:
        return len(self.files)

    def is_seekable(self) -> bool:
        return True

    @property
    def tr(self) -> Optional[np.ndarray]:
        return self.calib.get("Tr") if self.calib else None

    def gt_poses(self) -> Optional[np.ndarray]:
        """Ground-truth poses found beside the sequence, in the velodyne
        frame, or None."""
        seq = os.path.basename(os.path.normpath(self.seq_dir))
        candidates = [
            os.path.join(self.seq_dir, "poses.txt"),
            os.path.join(os.path.dirname(os.path.normpath(self.seq_dir)),
                         os.pardir, "poses", f"{seq}.txt"),
            os.path.join(self.seq_dir, os.pardir, os.pardir, "poses",
                         f"{seq}.txt"),
        ]
        for c in candidates:
            if os.path.isfile(c):
                return load_poses(c, self.tr)
        return None

    def read(self, idx: int) -> KittiScan:
        if self._native is not None:
            points, rem = self._native.read(idx)
        else:
            points, rem = read_bin(self.files[idx])
        n = points.shape[0]
        if self.label_files is not None:
            labels = read_label(self.label_files[idx])[:n]
            probs = np.where(labels > 0, 1.0, 0.0).astype(np.float32)
        elif self.segmenter is not None:
            lab, prob = self.segmenter(points, rem)
            if isinstance(lab, torch.Tensor):
                # a segmenter's tensors stay where it made them (on the GPU
                # for a GPU segmenter): the pipeline takes them without a
                # read of the device
                labels, probs = lab.to(torch.int32), prob.to(torch.float32)
            else:
                labels = np.asarray(lab, np.int32)
                probs = np.asarray(prob, np.float32)
        else:
            labels = np.zeros(n, np.int32)
            probs = np.ones(n, np.float32)
        return KittiScan(points=points, remissions=rem, labels=labels,
                         probs=probs)
