"""The reference runs and the numbers that decide ``correct``.

After the window, the reference works out again from the benchmark's own
inputs (the rendered scans, the weights file) what the program derived:

* the SLAM trajectory: the frozen plain copy (``slam``) drives the same
  scans through the same entry (``process_scan_async`` then ``flush`` and
  ``finalize``, or ``process_scan``), with the simulator's labels or with
  labels from the reference network; ``pose_gap_m`` is the largest distance
  between a program's pose and the reference's over every scan of every
  sequence of the window;
* the segmenter: a float32 forward (TF32 off) of the same weights on the
  same scans; ``logit_gap`` is the widest gap by which the logit of the
  class the program picked lies below the reference's best, over the valid
  pixels of the sampled scans; ``vote_mismatch`` counts the points whose
  label differs from the plain KNN vote of the program's own logits.

``precision`` runs the reference as the control instead: ``"tf32"``
(matrix products and convolutions in TF32) for the SLAM, ``"fp8"``
(float8 convolutions, emulated) for the network."""

from __future__ import annotations

import pickle
from contextlib import contextmanager

import numpy as np
import torch

from .. import harness
from .slam import config as rc
from .slam.core.pipeline import SurfelSLAM
from .slam.models.rangenet import make_input
from .slam.ops.knn import labels_for_points
from .slam.ops.projection import project_scan


def suma_config(sections: dict) -> rc.SumaConfig:
    """The reference's configuration from a config file's ``suma`` group."""
    kinds = {"data": rc.DataConfig, "model": rc.DataConfig,
             "icp": rc.IcpConfig, "map": rc.MapConfig,
             "loop": rc.LoopClosureConfig,
             "preprocess": rc.PreprocessConfig,
             "semantic": rc.SemanticConfig}
    kw = {k: (kinds[k](**v) if k in kinds else v)
          for k, v in sections.items()}
    return rc.SumaConfig(**kw)


@contextmanager
def precision(mode: str):
    """TF32 off (``"fp32"``, the reference) or on (``"tf32"``, the control)
    for matrix products and convolutions, restored afterwards."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    on = mode == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


class Network:
    """The segmenter's network, ``nets/<arch>.py`` of the group's ``arch``,
    read from the weights file: ``float32`` (the reference) or ``fp8`` (the
    control) convolutions."""

    def __init__(self, seg: dict, device, mode: str = "fp32",
                 weights_path: str | None = None):
        arch = harness.net(seg["arch"])
        with open(weights_path or seg["weights"], "rb") as f:
            blob = pickle.load(f)
        dtype = torch.float8_e4m3fn if mode == "fp8" else torch.float32
        self.net = arch.build(seg, dtype)
        self.net.load_state_dict(arch.state_dict(blob, seg))
        self.net = self.net.to(device).eval().requires_grad_(False)
        self.data = rc.DataConfig(**seg["data"])
        self.use_knn = seg["use_knn"]

    @torch.no_grad()
    def logits(self, points: torch.Tensor):
        """``(logits [H, W, C] float32, projection)`` of one scan, as the
        port's ``Segmenter`` builds its input (remissions 0)."""
        rem = torch.zeros(points.shape[:1], dtype=torch.float32,
                          device=points.device)
        res = project_scan(points, remissions=rem, cfg=self.data)
        x = make_input(res.vertex_map, res.depth_map, res.remission,
                       res.vertex_valid)[None]
        return self.net(x)[0].float(), res

    @torch.no_grad()
    def labels(self, points: torch.Tensor, logits=None, res=None):
        """Per-point ``(raw label, probability)``: the plain vote of
        ``logits`` (the network's own when not given)."""
        if logits is None:
            logits, res = self.logits(points)
        elif res is None:
            _, res = self.logits(points)
        depth = torch.linalg.vector_norm(points, dim=-1)
        return labels_for_points(
            logits, res.point_px.clamp_min(0), res.point_py.clamp_min(0),
            depth, res.point_px >= 0, res.depth_map, use_knn=self.use_knn)


def slam_trajectory(cfg: rc.SumaConfig, scans, labels, mode: str,
                    pipeline_depth: int, device) -> np.ndarray:
    """The reference's ``[N, 4, 4]`` trajectory of one sequence: each scan
    ``(points, labels, probs, valid)`` through ``process_scan_async`` then
    ``flush`` and ``finalize`` (``mode`` ``"offline"``) or through
    ``process_scan`` then ``finalize`` (``"online"``)."""
    slam = SurfelSLAM(cfg, pipeline_depth=pipeline_depth, device=device)
    try:
        for s, (lab, prob) in zip(scans, labels):
            if mode == "online":
                slam.process_scan(s.points, lab, prob, s.valid)
            else:
                slam.process_scan_async(s.points, lab, prob, s.valid)
        slam.flush()
        slam.finalize()
        return slam.trajectory().astype(np.float64)
    finally:
        if slam._loop is not None and slam._loop._executor is not None:
            slam._loop._executor.shutdown(wait=True)


def pose_gap(trajectories, reference: np.ndarray) -> float:
    """The largest distance (m) between a pose of any of ``trajectories``
    and the reference's pose of the same scan; inf where a trajectory is
    short or not finite."""
    worst = 0.0
    for t in trajectories:
        if t.shape != reference.shape or not np.all(np.isfinite(t)):
            return float("inf")
        d = np.linalg.norm(t[:, :3, 3] - reference[:, :3, 3], axis=-1)
        worst = max(worst, float(d.max()))
    return worst


def logit_gap(program_logits: torch.Tensor, reference_logits: torch.Tensor,
              valid: torch.Tensor) -> float:
    """The widest gap, over the valid pixels, by which the reference's logit
    of the class the program picked lies below the reference's best."""
    pick = program_logits.float().argmax(dim=-1, keepdim=True)
    ref = reference_logits.float()
    gap = ref.amax(dim=-1) - ref.gather(-1, pick)[..., 0]
    return float(gap[valid].max()) if bool(valid.any()) else 0.0
