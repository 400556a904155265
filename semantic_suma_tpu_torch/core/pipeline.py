"""The per-scan SLAM pipeline, odometry path (counterpart of
``semantic_suma_tpu/core/pipeline.py``): preprocess -> frame-to-model ICP ->
track-loss fallback -> map fusion -> model render.

The JAX package compiles one device program per scan. Here the step runs
eagerly; the Gauss-Newton loop, the fallback, the view refresh and the
creation append read a few scalars to the host (``device.to_host``, counted
in ``StepInfo.syncs``) to choose their branch. ``SurfelSLAM`` drives the step
with loop closure and host spill OFF (neither is ported yet).
"""

from __future__ import annotations

import time
from dataclasses import replace
from typing import NamedTuple

import numpy as np
import torch

from ..config import SumaConfig
from ..device import resolve_device, to_host
from ..ops import icp as icp_ops
from ..ops.icp import Maps
from ..utils import lie
from . import surfel_map as sm
from .preprocessing import empty_maps, preprocess_scan


class SlamState(NamedTuple):
    """Pipeline state carried from scan to scan."""

    map: sm.MapState
    pose: torch.Tensor            # [4,4] current world<-sensor
    last_increment: torch.Tensor  # [4,4]
    last_maps: Maps               # previous frame's data maps
    model_maps: Maps              # model render at `pose` (for next ICP)
    timestamp: torch.Tensor       # int32


class StepInfo(NamedTuple):
    pose: torch.Tensor
    increment: torch.Tensor
    stats: icp_ops.IcpStats
    iterations: int
    track_loss: bool              # the fallback alignment ran
    n_created: int
    n_dropped: int                # creations lost to an exhausted arena
    map_count: torch.Tensor
    syncs: int                    # host reads the step made (to_host)


class StageTimer:
    """Device time per stage of :func:`odometry_step`, from CUDA events
    recorded at the stage boundaries on the current stream (host clock on the
    CPU). Read with :meth:`summary` after the run."""

    STAGES = ("preprocess", "gauss_newton", "fuse_render")

    def __init__(self):
        self._marks: list = []

    def _stamp(self, device):
        if device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def mark(self, device, name):
        """Record the boundary that ends stage ``name`` (None starts a
        step)."""
        self._marks.append((name, self._stamp(device)))

    def summary(self) -> dict:
        """Mean ms per stage over the recorded steps."""
        total = {s: 0.0 for s in self.STAGES}
        count = {s: 0 for s in self.STAGES}
        if self._marks and not isinstance(self._marks[0][1], float):
            torch.cuda.synchronize()
        prev = None
        for name, stamp in self._marks:
            if name is not None and prev is not None:
                if isinstance(stamp, float):
                    ms = (stamp - prev) * 1e3
                else:
                    ms = prev.elapsed_time(stamp)
                total[name] += ms
                count[name] += 1
            prev = stamp
        return {s: total[s] / count[s] for s in self.STAGES if count[s]}


def init_state(cfg: SumaConfig, device=None) -> SlamState:
    dev = resolve_device(device)
    return SlamState(
        map=sm.empty_map(cfg.map, dev),
        pose=torch.eye(4, dtype=torch.float32, device=dev),
        last_increment=torch.eye(4, dtype=torch.float32, device=dev),
        last_maps=empty_maps(cfg, dev),
        model_maps=empty_maps(cfg, dev),
        timestamp=torch.zeros((), dtype=torch.int32, device=dev),
    )


def odometry_step(state: SlamState, points: torch.Tensor,
                  labels: torch.Tensor, probs: torch.Tensor,
                  point_valid: torch.Tensor, conf_threshold,
                  cfg: SumaConfig, timer: StageTimer | None = None):
    """Process one scan. Returns (new_state, StepInfo). The input state is
    consumed: its map arena and pose table are updated in place."""
    dev = state.pose.device
    reads0 = to_host.count
    ts = state.timestamp
    semantic = cfg.semantic.enabled
    if timer is not None:
        timer.mark(dev, None)

    data_maps = preprocess_scan(points, labels, probs, point_valid,
                                ts < cfg.semantic.init_scans, cfg)
    if timer is not None:
        timer.mark(dev, "preprocess")

    ref_maps = state.model_maps if cfg.approach == "frame-to-model" \
        else state.last_maps
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    t0 = eye if cfg.icp.initialize_identity else state.last_increment

    result = icp_ops.gauss_newton(data_maps, ref_maps, t0, cfg.icp, cfg.model,
                                  semantic=semantic)
    increment = result.pose
    iterations = result.iterations

    # track-loss fallback: if the increment jumps w.r.t. the motion model,
    # redo the alignment frame-to-frame with tighter gates
    jumped = False
    if cfg.icp.fallback_mode:
        delta = lie.se3_inverse(state.last_increment) @ increment
        t_err = torch.linalg.norm(delta[:3, 3])
        r_err = lie.rotation_angle(delta)
        jumped = to_host((ts > 1)
                         & ((t_err > cfg.icp.fallback_translation_jump)
                            | (r_err > cfg.icp.fallback_rotation_jump)))
        if jumped:
            recovery_cfg = replace(cfg.icp,
                                   max_distance=cfg.icp.fallback_max_distance,
                                   max_angle=cfg.icp.fallback_max_angle)
            rec = icp_ops.gauss_newton(data_maps, state.last_maps, t0,
                                       recovery_cfg, cfg.data,
                                       semantic=semantic)
            increment = rec.pose

    increment = torch.where(ts == 0, eye, increment)  # first scan: no motion
    new_pose = lie.orthonormalize(state.pose @ increment)
    if timer is not None:
        timer.mark(dev, "gauss_newton")

    frame = sm.data_surfel_init(data_maps, cfg.data, cfg.map)
    new_map, model_maps, n_created, n_dropped = sm.fuse_and_render(
        state.map, frame, new_pose, ts, cfg.data, cfg.map, conf_threshold,
        (ts + 1) - cfg.loop.delta_timestamp, semantic=semantic)
    if timer is not None:
        timer.mark(dev, "fuse_render")

    new_state = SlamState(map=new_map, pose=new_pose, last_increment=increment,
                          last_maps=data_maps, model_maps=model_maps,
                          timestamp=ts + 1)
    info = StepInfo(pose=new_pose, increment=increment, stats=result.stats,
                    iterations=iterations, track_loss=jumped,
                    n_created=n_created, n_dropped=n_dropped,
                    map_count=new_map.count,
                    syncs=to_host.count - reads0)
    return new_state, info


class SurfelSLAM:
    """Host-side loop: owns the state, the pose log and the statistics.
    Synchronous: :meth:`process_scan` returns the result of its own scan.
    Loop closure and host spill are not ported; a configuration that enables
    either is refused."""

    def __init__(self, cfg: SumaConfig, enable_loop_closure: bool | None = None,
                 device=None):
        do_loops = cfg.loop.enabled if enable_loop_closure is None \
            else enable_loop_closure
        if do_loops and cfg.approach == "frame-to-model":
            raise NotImplementedError(
                "loop closure is not ported yet: disable cfg.loop.enabled")
        if cfg.map.spill_enabled:
            raise NotImplementedError(
                "host spill is not ported yet: disable cfg.map.spill_enabled")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.state = init_state(cfg, self.device)
        self.timer: StageTimer | None = None
        self.poses: list = []
        self.statistics: list = []
        self.track_loss_count = 0
        self.creations_dropped = 0
        self.syncs = 0

    @property
    def timestamp(self) -> int:
        return len(self.poses)

    def _conf_at(self, t: int) -> float:
        """Confidence warmup schedule at scan ``t``."""
        cfg = self.cfg.map
        if t < cfg.time_init:
            a = t / cfg.time_init
            return (1.0 - a) * cfg.log_unstable + a * cfg.confidence_threshold
        return cfg.confidence_threshold

    def process_scan(self, points, labels=None, probs=None, point_valid=None):
        """Feed one scan; returns its statistics dict."""
        t_start = time.perf_counter()
        dev = self.device
        points = torch.as_tensor(points, dtype=torch.float32, device=dev)
        n = points.shape[0]
        labels = (torch.zeros((n,), dtype=torch.int32, device=dev)
                  if labels is None else torch.as_tensor(labels, device=dev))
        probs = (torch.ones((n,), dtype=torch.float32, device=dev)
                 if probs is None else torch.as_tensor(probs, device=dev))
        point_valid = (torch.ones((n,), dtype=torch.bool, device=dev)
                       if point_valid is None
                       else torch.as_tensor(point_valid, device=dev))
        ct = self._conf_at(self.timestamp)
        self.state, info = odometry_step(self.state, points, labels, probs,
                                         point_valid, ct, self.cfg,
                                         timer=self.timer)

        # ONE device->host read for everything the host keeps
        s = info.stats
        vec = np.asarray(to_host(torch.cat([
            info.pose.reshape(-1).to(torch.float64), torch.stack([
                s.error.double(), s.valid.double(), s.inlier.double(),
                s.outlier.double(), s.invalid.double(),
                info.map_count.double()])])))
        self.syncs += info.syncs + 1
        pose = vec[:16].reshape(4, 4)
        error, valid, inlier, outlier, invalid, map_count = vec[16:]

        # compaction when the arena could overflow or a creation was dropped
        cap = self.cfg.map.surfel_capacity
        hw = self.cfg.data.height * self.cfg.data.width
        self.creations_dropped += info.n_dropped
        if map_count + hw > cap or info.n_dropped:
            self.state = self.state._replace(
                map=sm.compact(self.state.map, self.cfg.map))

        self.poses.append(pose)
        self.track_loss_count += int(info.track_loss)
        stats = {
            "icp-iterations": info.iterations,
            "icp-error": float(error),
            "icp-inlier": int(inlier),
            "icp-outlier": int(outlier),
            "icp-valid": int(valid),
            "icp-invalid": int(invalid),
            "track-loss": info.track_loss,
            "map-count": int(map_count),
            "surfels-created": info.n_created,
            "creations-dropped": info.n_dropped,
            "complete-time": time.perf_counter() - t_start,
        }
        self.statistics.append(stats)
        return stats

    def flush(self):
        """Nothing is ever in flight (process_scan is synchronous); returns the
        last statistics dict or None."""
        return self.statistics[-1] if self.statistics else None

    def trajectory(self) -> np.ndarray:
        return np.stack(self.poses) if self.poses else np.zeros((0, 4, 4))
