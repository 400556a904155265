"""Loop-closure detection, verification, and pose-graph integration
(counterpart of ``semantic_suma_tpu/core/loop_closure.py``).

A host-side state machine on numpy that drives device subroutines (old-map
render, ICP against the old map, composed-view residual evaluation):

* Phase A: verify a pending candidate every scan. ICP against the old
  (inactive) map rendered at the tracked old-frame pose; gates
  valid_ratio > 0.2, outlier_ratio < 0.85, |log(inc_new)-log(inc_old)| < 0.1;
  then compare the composed-view residual against the odometry result. On
  host loops that support it, verification runs as a per-scan device program
  chained off the odometry step with the pose_old anchor carried ON DEVICE
  (``dispatch_verify``), so live chains never drain the scan pipeline.
* Promotion: ``min_verifications + 1`` consecutive successes make the chain
  verified; verified candidates become robust between-factor edges.
* Optimization: Gauss-Newton+PCG pose-graph solve on a background host
  thread over a clone of the graph; ``integrate`` applies the result on a
  later scan via difference-rebase, skipping the device rebase below the
  configured gates.
* Phase C: search a new candidate when idle: nearest old pose within
  search_distance with trajectory distance > min_trajectory_distance; three
  initializations {O, R(O), half-translation O}.

The JAX package compiles "render -> Gauss-Newton -> re-render -> compose ->
evaluate" into one program per phase with one fetch. Here ``verify``,
``search`` and ``verify_chain`` are plain functions on tensors with the same
arguments and packed result vectors, each read with ONE host fetch; the
Gauss-Newton loops inside them still read the host once an iteration
(``ops/icp.py``).
"""

from __future__ import annotations

import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..config import SumaConfig
from ..device import AsyncFetch, resolve_device, to_host
from ..ops import icp as icp_ops
from ..ops.icp import Maps
from ..ops.pyramid import gauss_newton_pyramid
from ..utils import lie
from ..utils.timing import span
from . import surfel_map as sm
from .posegraph import Posegraph

# Graphs of at most this many poses are solved on the host CPU (the caller
# ASKS for it, nothing falls back); larger graphs go to the host loop's
# device. The number is measured, not inherited: ``chip_smoke.py`` solves
# ring graphs of 128 to 4096 poses both ways on an H100. At 128 poses the
# CPU is as fast as the card or faster (a solve is ~650 dependent steps of
# a few launches each, whatever the size); at 256 poses the card wins most
# readings, from 512 on all of them, by 3x at 4096 (PERF.md, section 5).
SMALL_GRAPH_POSES = 128


def _stats_vec(st: icp_ops.IcpStats) -> torch.Tensor:
    return torch.stack([x.to(torch.float32).reshape(())
                        for x in (st.error, st.valid, st.inlier, st.outlier,
                                  st.inlier_residual, st.invalid)])


def _pack_gn(pose: torch.Tensor, stats: icp_ops.IcpStats) -> torch.Tensor:
    """(pose, stats) -> one f32 [28] vector: pose [0:16], se3_log(pose)
    [16:22], error/valid/inlier/outlier/inlier_residual/invalid [22:28]."""
    pose = pose.to(torch.float32)
    return torch.cat([pose.reshape(-1), lie.se3_log(pose).reshape(-1),
                      _stats_vec(stats)])


def _host_stats(v) -> icp_ops.IcpStats:
    return icp_ops.IcpStats(*[float(x) for x in v])


def _fetch_gn(pose, stats):
    """Fetch a GN/evaluate result with ONE transfer; returns
    (pose np[4,4], log np[6], IcpStats of floats)."""
    v = np.asarray(to_host(_pack_gn(pose, stats)), np.float32)
    return v[:16].reshape(4, 4).copy(), v[16:22].copy(), _host_stats(v[22:28])


def _where_maps(flag: torch.Tensor, a: Maps, b: Maps) -> Maps:
    return Maps(*[torch.where(flag, x, y) for x, y in zip(a, b)])


@dataclass
class LoopClosureCandidate:
    frm: int
    to: int
    rel_pose: np.ndarray  # pose_old^-1 @ posegraph.pose(to)


class OldMapRenderCache:
    """Staleness-managed old-(inactive-)map renderer; the host loop injects its
    view build and render callables.

    Staleness tolerance (deliberate): between rebuilds, surfels
    integrated/culled since cache-build time and blocks whose old/new
    membership flipped are not reflected in verification renders. The
    bounds (8 m of query motion, about two verification windows of split
    drift) keep that divergence well inside the verification gates' slack:
    the *old* map changes slowly by construction (only a pose rebase touches
    it, which bumps ``map_version`` and invalidates here). A full rebuild
    also happens on every rebase/compaction.
    """

    def __init__(self, build_view, render_view, delta_timestamp: int,
                 motion_bound: float = 8.0, thr_bound: int = 12):
        self._build_view = build_view    # (center np f32[3], thr int) -> view
        self._render = render_view       # (view, pose np, conf, thr) -> Maps
        self.delta_timestamp = delta_timestamp
        self.motion_bound = motion_bound
        self.thr_bound = thr_bound
        self._view = None
        self._center: Optional[np.ndarray] = None
        self._version = -1
        self._thr = -1
        self._last_render: Optional[tuple] = None

    def view_for(self, view_pose, timestamp: int, map_version: int):
        """Device view (active subset) covering ``view_pose``, rebuilt on
        staleness; returns (view, ts_threshold)."""
        pose = np.asarray(view_pose, np.float32)
        thr = timestamp - self.delta_timestamp
        stale = (self._view is None
                 or self._version != map_version
                 or self._thr + self.thr_bound < thr
                 or np.linalg.norm(pose[:3, 3] - self._center)
                 > self.motion_bound)
        if stale:
            self._view = self._build_view(pose[:3, 3].copy(), int(thr))
            self._center = pose[:3, 3].copy()
            self._version = map_version
            self._thr = thr
            self._last_render = None
        return self._view, self._thr

    def render(self, view_pose, timestamp: int, conf_threshold: float,
               map_version: int):
        pose = np.asarray(view_pose, np.float32)
        view, thr = self.view_for(view_pose, timestamp, map_version)
        if self._last_render is not None and \
                np.array_equal(self._last_render[0], pose):
            return self._last_render[1]
        maps = self._render(view, pose, float(conf_threshold), int(thr))
        self._last_render = (pose.copy(), maps)
        return maps


@dataclass
class LoopCloser:
    cfg: SumaConfig
    posegraph: Posegraph = field(default_factory=Posegraph)
    unverified: List[LoopClosureCandidate] = field(default_factory=list)
    verified: List[LoopClosureCandidate] = field(default_factory=list)
    already_verified: bool = False
    time_without_loop: int = 0
    loop_count: int = 0
    pose_old: Optional[np.ndarray] = None       # current old-frame pose
    last_pose_old: Optional[np.ndarray] = None
    num_optimizations: int = 0
    num_loop_closures: int = 0
    num_rebases: int = 0          # above-gate integrations (device rebase)
    num_soft_integrations: int = 0  # below-gate (host-only, no drain)
    # set when a device-dependent phase was deferred because scans were in
    # flight; the host loop must drain the pipeline and run synchronously
    sync_request: bool = False
    # set by host loops that support the device-carried verification chain
    # (dispatch_verify); leaves the pipeline running through live
    # candidate chains instead of draining per scan
    pipelined_ok: bool = False
    # where the device subroutines and the large-graph solves run: the card
    # unless the caller names another device
    device: object = None

    @property
    def chain_live(self) -> bool:
        return bool(self.unverified or self.already_verified)

    @property
    def sync_needed(self) -> bool:
        """True when the next scan's on_scan may touch device state that
        must be exactly current: the pipelined host loop drains all in-flight
        scans first and runs synchronously. With the pipelined verification
        chain (pipelined_ok) a live candidate chain does not force draining,
        and with async_optimize the graph solve runs on a background thread;
        only an explicitly deferred phase (candidate search, sync-mode
        optimization) drains."""
        if self.sync_request:
            return True
        if self.chain_live and not self.pipelined_ok:
            return True
        if self.loop_count > 0 and not self.cfg.loop.async_optimize:
            return True
        return False

    @property
    def needs_integration(self) -> bool:
        """A background graph optimization finished and awaits integration
        (host loops poll this at dispatch boundaries)."""
        return self._opt_future is not None and self._opt_future.done()

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.posegraph.set_initial(0, np.eye(4))
        # diagonal information in [v, omega] residual order
        info = np.ones(6, np.float32)
        if self.cfg.odometry_info_translation:
            info[:3] *= self.cfg.odometry_info_translation ** -2
        if self.cfg.odometry_info_rotation:
            info[3:] *= self.cfg.odometry_info_rotation ** -2
        self._info = info
        self._fused = None
        self._pre = None
        # pipelined verification chain state: FIFO of (dispatch index,
        # fetch in flight) + the device-resident pose_old carry
        self._verify_queue: "deque" = deque()
        self._pose_old_dev = None
        self._last_comp = None
        self._last_comp_pose = None
        # async graph optimization
        self._opt_future = None
        self._opt_ts = -1
        self._opt_before = None
        self._executor = None

    def _t(self, x) -> torch.Tensor:
        """A host array as a float32 tensor on the closer's device."""
        if isinstance(x, torch.Tensor):
            return x.to(self.device, torch.float32)
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def _solve_device(self, n_poses: int):
        """The small-graph rule, in this one place."""
        return "cpu" if n_poses <= SMALL_GRAPH_POSES else self.device

    # ------------------------------------------------------------------
    def pre_dispatch(self, slam) -> None:
        """Dispatch the phase-A verification right after the odometry step's
        dispatch (before its fetch), so both results travel to the host
        together. All inputs are device references of the just-dispatched
        scan (identical to what phase A would use at drain time); the host
        gates are applied in on_scan when both results have arrived."""
        self._pre = None
        if not (self.unverified or self.already_verified):
            return
        if not getattr(slam, "supports_fused_verify", False):
            return
        if self._fused is None:
            self._build_fused()
        # the scan's explicit dispatch count (== len(poses)+1 == the
        # timestamp the drain-time path would read), so both use identical
        # inputs
        view, thr = slam.old_view(self.pose_old,
                                  timestamp=getattr(slam, "_dispatched",
                                                    slam.timestamp))
        vec, comp = self._fused[0](
            view, thr, self._t(self.pose_old), slam.last_maps,
            slam.model_maps, self._t(slam.last_increment),
            slam.confidence_threshold())
        self._pre = (AsyncFetch(vec), comp)

    # ------------------------------------------------------------------
    def warmup(self, slam) -> None:
        """Run every loop-phase device routine once at start-up instead
        of mid-drive: the three programs (at the search view's and the
        verify view's shapes, so the z-buffer's workspace tables for them
        exist before any CUDA-graph capture), one tiny pose-graph solve,
        the rebase with the run's own poses (value-identical) and one
        compaction, so kernel builds and library handles are paid before
        the timed laps. The two view caches are dropped afterwards."""
        if not getattr(slam, "supports_fused_verify", False):
            return
        with span(getattr(slam, "stopwatch", None), "loop-warmup"):
            if self._fused is None:
                self._build_fused()
            eye = np.eye(4, dtype=np.float32)
            eye_t = self._t(eye)
            maps = slam.last_maps
            # full view (candidate search) + reduced view (chained verify)
            view_f, thr_f = slam.old_view(eye, timestamp=0)
            self._fused[1](view_f, thr_f, eye_t, torch.stack([eye_t] * 3),
                           maps, maps, 0.0)
            self._fused[0](view_f, thr_f, eye_t, maps, maps, eye_t, 0.0)
            if hasattr(slam, "verify_view"):
                view_v, thr_v = slam.verify_view(eye, timestamp=0)
                self._fused[2](view_v, thr_v, eye_t, maps, maps, eye_t, eye_t,
                               0.0)
            for dev in {str(self._solve_device(2)), str(self.device)}:
                g = Posegraph()
                g.set_initial(0, eye)
                g.set_initial(1, eye)
                g.add_edge(0, 1, eye, robust=True)
                g.optimize(robust_kernel=self.cfg.loop.robust_kernel,
                           robust_delta=self.cfg.loop.robust_delta, device=dev)
            if hasattr(slam, "rebase"):
                cur = slam.poses[-1] if slam.poses else eye
                arr = np.stack(slam.poses) if slam.poses else eye[None]
                slam.rebase(arr, cur)
            if hasattr(slam, "compact_map"):
                slam.compact_map()
            # composed-tracking path (lag-0 sync re-entry)
            if hasattr(slam, "render_old_maps"):
                sm.compose_views(slam.render_old_maps(eye), maps,
                                 self.cfg.loop.max_loop_closure_distance)
            # the identity-centered view caches are stale the moment the
            # vehicle is >8 m from the origin; drop them so the first real
            # verification builds fresh ones
            for cache in (getattr(slam, "_old_cache", None),
                          getattr(slam, "_verify_cache", None)):
                if cache is not None:
                    cache._view = None

    # ------------------------------------------------------------------
    def dispatch_verify(self, slam, idx: int) -> None:
        """Pipelined phase-A verification for scan ``idx``: dispatched right
        after the scan's odometry step, with the pose_old anchor CARRIED ON
        DEVICE between consecutive dispatches (the host gates are folded
        into the device program), so a live candidate chain does not drain
        the pipeline. The packed result is consumed by on_scan when the scan
        drains; the composed old+new model render replaces the model maps
        immediately (device reference, no host work), giving composed
        tracking for the next scan."""
        with span(getattr(slam, "stopwatch", None), "verify-dispatch"):
            if self._fused is None:
                self._build_fused()
            if self._pose_old_dev is None:
                # seed the carry from the host anchor (chain start; host
                # poses are device-frame @ frame_correction)
                corr = getattr(slam, "frame_correction", None)
                anchor = self.pose_old
                if corr is not None:
                    anchor = np.linalg.inv(corr) @ anchor
                self._pose_old_dev = self._t(anchor)
            if hasattr(slam, "verify_view"):
                view, thr = slam.verify_view(self.pose_old,
                                             timestamp=idx + 1)
            else:
                view, thr = slam.old_view(self.pose_old, timestamp=idx + 1)
            vec, comp_out, pose_old_next = self._fused[2](
                view, thr, self._pose_old_dev, slam.last_maps,
                slam.model_maps, self._t(slam.last_increment),
                self._t(slam.pose),
                slam._conf_at(idx))
            self._pose_old_dev = pose_old_next
            self._verify_queue.append((idx, AsyncFetch(vec)))
            if self.cfg.loop.compose_rendering:
                slam.set_model_maps(comp_out)

    # ------------------------------------------------------------------
    def _build_fused(self):
        """The three per-phase programs: old-map render, (pyramid) GN
        alignment, composed-view re-render and its residual evaluation, each
        returning ONE packed float32 vector for one host fetch."""
        cfg = self.cfg
        icp_cfg, model_cfg, mcfg = cfg.icp, cfg.model, cfg.map
        sem = cfg.semantic.enabled
        maxd = cfg.loop.max_loop_closure_distance
        levels = cfg.loop.search_levels
        lcfg = cfg.loop

        def render_old(view, pose, conf, thr):
            return sm.render_view(view, pose, model_cfg, mcfg, conf, thr,
                                  "old")

        def align(data_maps, old_maps, init):
            if levels > 1:
                return gauss_newton_pyramid(
                    data_maps, old_maps, init, icp_cfg, model_cfg,
                    levels=levels, semantic=sem)
            return icp_ops.gauss_newton(data_maps, old_maps, init, icp_cfg,
                                        model_cfg, semantic=sem)

        def composed_stats(old2, data_maps, model_maps):
            comp = sm.compose_views(old2, model_maps, maxd)
            eye = torch.eye(4, dtype=torch.float32,
                            device=data_maps.vertex.device)
            return comp, icp_ops.evaluate(eye, data_maps, comp, icp_cfg,
                                          model_cfg, semantic=sem)

        def verify(view, thr, last_pose_old, data_maps, model_maps, t0,
                   conf):
            old_maps = render_old(view, last_pose_old, conf, thr)
            res = icp_ops.gauss_newton(data_maps, old_maps, t0, icp_cfg,
                                       model_cfg, semantic=sem)
            inc_old = res.pose.to(torch.float32)
            pose_old_new = last_pose_old @ inc_old
            old2 = render_old(view, pose_old_new, conf, thr)
            comp, cstats = composed_stats(old2, data_maps, model_maps)
            vec = torch.cat([
                inc_old.reshape(-1),                      # 0:16
                lie.se3_log(inc_old).reshape(-1),         # 16:22
                _stats_vec(res.stats),                    # 22:28
                _stats_vec(cstats),                       # 28:34
                pose_old_new.reshape(-1)])                # 34:50
            return vec, comp

        def verify_chain(view, thr, pose_old_prev, data_maps, model_maps,
                         inc, odo_pose, conf):
            """Device-carried phase-A verification: like ``verify`` but the
            host gates are evaluated ON DEVICE and select the next pose_old
            carry, so consecutive verifications chain dispatch to dispatch
            with no host read between them. Returns
            (vec[51], composed-model maps, pose_old_next)."""
            old_maps = render_old(view, pose_old_prev, conf, thr)
            res = icp_ops.gauss_newton(data_maps, old_maps, inc, icp_cfg,
                                       model_cfg, semantic=sem)
            inc_old = res.pose.to(torch.float32)
            pose_old_new = pose_old_prev @ inc_old
            outl, inl, val, inv = (x.to(torch.float32) for x in (
                res.stats.outlier, res.stats.inlier, res.stats.valid,
                res.stats.invalid))
            orr = outl / torch.clamp_min(outl + inl, 1.0)
            vr = val / torch.clamp_min(val + inv, 1.0)
            inc_diff = torch.linalg.norm(
                lie.se3_log(inc.to(torch.float32)) - lie.se3_log(inc_old))
            gates = (vr > lcfg.min_valid_ratio) \
                & (orr < lcfg.max_outlier_ratio) \
                & (inc_diff < lcfg.max_increment_difference)
            old2 = render_old(view, pose_old_new, conf, thr)
            comp, cstats = composed_stats(old2, data_maps, model_maps)
            pose_old_next = torch.where(gates, pose_old_new, odo_pose)
            # composed tracking output: compose at the verified anchor on
            # success; at the previous anchor's render on gate failure (one
            # scan of anchor staleness is within the old-map cache's
            # documented tolerance)
            comp_fail = sm.compose_views(old_maps, model_maps, maxd)
            comp_out = _where_maps(gates, comp, comp_fail)
            vec = torch.cat([
                inc_old.reshape(-1),                      # 0:16
                lie.se3_log(inc_old).reshape(-1),         # 16:22
                _stats_vec(res.stats),                    # 22:28
                _stats_vec(cstats),                       # 28:34
                pose_old_new.reshape(-1),                 # 34:50
                gates.to(torch.float32).reshape(1)])      # 50
            return vec, comp_out, pose_old_next

        def search(view, thr, pose_prior, inits, data_maps, model_maps,
                   conf):
            old_maps = render_old(view, pose_prior, conf, thr)
            rows = []
            for k in range(3):
                res = align(data_maps, old_maps, inits[k])
                cand_pose = pose_prior @ res.pose.to(torch.float32)
                old2 = render_old(view, cand_pose, conf, thr)
                _, cstats = composed_stats(old2, data_maps, model_maps)
                rows.append(torch.cat([
                    cand_pose.reshape(-1),                # 0:16
                    _stats_vec(res.stats),                # 16:22
                    _stats_vec(cstats)]))                 # 22:28
            return torch.stack(rows)                      # [3, 28]

        self._fused = (verify, search, verify_chain)

    # ------------------------------------------------------------------
    def _ratios(self, stats: icp_ops.IcpStats):
        inl = float(stats.inlier)
        out = float(stats.outlier)
        val = float(stats.valid)
        inv = float(stats.invalid)
        outlier_ratio = out / max(out + inl, 1.0)
        valid_ratio = val / max(val + inv, 1.0)
        residual = float(stats.error) / max(val, 1.0)
        return valid_ratio, outlier_ratio, residual

    def _render_old(self, slam, view_pose):
        """Inactive-map render at ``view_pose`` via the host loop's cached
        old-view renderer."""
        return slam.render_old_maps(view_pose)

    def _align_candidate(self, data, model, init):
        """Candidate-search ICP. Initializations here can be meters off
        after drift, so a coarse-to-fine pyramid (search_levels > 1) widens
        the projective-association basin; level 0 = the odometry solver."""
        levels = self.cfg.loop.search_levels
        init = self._t(init)
        if levels > 1:
            return gauss_newton_pyramid(
                data, model, init, self.cfg.icp, self.cfg.model,
                levels=levels, semantic=self.cfg.semantic.enabled)
        return icp_ops.gauss_newton(
            data, model, init, self.cfg.icp, self.cfg.model,
            semantic=self.cfg.semantic.enabled)

    def _composed_residual(self, slam, pose_old, pose_new):
        """Residual of the current scan against the composed old+new model:
        old map rendered at ``pose_old``, new map = the hot path's own model
        render at ``pose_new`` (the step's model_maps), merged in image
        space. ``pose_new`` is the current pose by construction."""
        old_maps = self._render_old(slam, pose_old)
        comp = sm.compose_views(old_maps, slam.model_maps,
                                self.cfg.loop.max_loop_closure_distance)
        eye = torch.eye(4, dtype=torch.float32, device=self.device)
        stats = icp_ops.evaluate(eye, slam.last_maps, comp, self.cfg.icp,
                                 self.cfg.model,
                                 semantic=self.cfg.semantic.enabled)
        _, _, host_stats = _fetch_gn(eye, stats)
        return host_stats

    def _closest_index(self, slam, query_pose) -> int:
        """Nearest old pose within search radius with sufficient trajectory
        separation, vectorized over the whole pose history."""
        ts = slam.timestamp - 1
        lim = ts - self.cfg.loop.delta_timestamp
        if lim < 0:
            return -1
        q = np.asarray(query_pose)[:3, 3]
        cand = self.posegraph.translations(lim + 1)     # [lim+1, 3]
        tdist = np.asarray(slam.trajectory_distances[:lim + 1])
        d = np.linalg.norm(cand - q[None, :], axis=-1)
        sep_ok = (slam.trajectory_distances[ts] - tdist) \
            > self.cfg.loop.min_trajectory_distance
        d = np.where(sep_ok, d, np.inf)
        j = int(np.argmin(d))
        return j if d[j] < self.cfg.loop.search_distance else -1

    # ------------------------------------------------------------------
    def on_scan(self, slam, info, lag: int = 0) -> dict:
        """Called after each odometry step with the step's StepInfo.

        ``lag`` is the number of scans dispatched AFTER this one that are
        still in flight (pipelined host loops). Host-only bookkeeping (graph
        edges, counters) always runs; the device-dependent phases
        (verification ICP, candidate search, graph rebase) require the
        device state to be exactly this scan's, so with ``lag > 0`` they
        are deferred and ``sync_request`` is raised: the host loop drains the
        pipeline and re-enters synchronously on the next scan. Deferring a
        candidate search is harmless (search repeats every idle scan).

        On every scan but the first the host-clock phases are the span
        ``loop`` (its lap ``loop``, the statistic ``loop-time``) and its
        children ``loop/bookkeep``, ``loop/verify``, ``loop/edges``,
        ``loop/opt``, ``loop/search`` and ``loop/compose``.
        """
        ts = slam.timestamp - 1  # index of the scan just processed
        if ts == 0:
            # odometry factor
            pose = np.asarray(info.pose)
            self.posegraph.set_initial(0, pose)
            self.pose_old = pose.copy()
            self.last_pose_old = pose.copy()
            return {"loop-count": 0}
        t_loop0 = time.perf_counter()
        sw = getattr(slam, "stopwatch", None)
        with span(sw, "loop"):
            stats = self._scan_phases(slam, info, ts, lag, sw)
        stats["loop-time"] = time.perf_counter() - t_loop0
        return stats

    def _scan_phases(self, slam, info, ts: int, lag: int, sw) -> dict:
        """:meth:`on_scan` of scan ``ts > 0``, phase by phase."""
        cfg = self.cfg.loop
        stats: dict = {}
        deferred = False
        with span(sw, "loop/bookkeep"):
            increment = np.asarray(info.increment)
            pose = np.asarray(info.pose)
            # odometry factor
            self.posegraph.set_initial(
                ts, self.posegraph.pose(ts - 1) @ increment)
            self.posegraph.add_edge(ts - 1, ts, increment, self._info)

            # old-frame pose track: by default follows odometry
            self.last_pose_old = self.pose_old
            self.pose_old = pose.copy()

            self.time_without_loop += 1

            vr_new, or_new, res_new = self._ratios(info.stats)
        # ---- phase A: verify pending candidates --------------------------
        with span(sw, "loop/verify"):
            self._last_comp = None
            qvec = None
            while self._verify_queue and self._verify_queue[0][0] < ts:
                # stale entries (chain restarted)
                self._verify_queue.popleft()
            if self._verify_queue and self._verify_queue[0][0] == ts:
                qvec = np.asarray(self._verify_queue.popleft()[1].wait())
            if self.chain_live and qvec is not None:
                # pipelined path: the verification ran on device when this
                # scan was dispatched (dispatch_verify); only host
                # bookkeeping here. Works at ANY lag: the device carry kept
                # the chain exact.
                corr = getattr(slam, "frame_correction", None)
                pose_old_new = qvec[34:50].reshape(4, 4).copy()
                if corr is not None:
                    pose_old_new = corr @ pose_old_new
                gates_ok = qvec[50] > 0
                verified_this_scan = False
                if gates_ok:
                    _, _, res_old = self._ratios(_host_stats(qvec[28:34]))
                    verified_this_scan = self._accept_verification(
                        slam, ts, pose_old_new, res_old, res_new)
                stats["loop-verifying"] = verified_this_scan
            elif self.chain_live and lag > 0:
                # the host loop recovers via sync_needed next scan
                deferred = True
            elif self.unverified or self.already_verified:
                inc_log = getattr(info, "inc_log", None)
                if inc_log is None:  # plain StepInfo (tests, other callers)
                    inc_log = lie.se3_log(torch.as_tensor(
                        increment, dtype=torch.float32)).numpy()
                if getattr(slam, "supports_fused_verify", False):
                    # one program, ONE fetch: already in flight when the host
                    # loop pre-dispatched it
                    pre, self._pre = self._pre, None
                    if pre is not None:
                        fetch, comp = pre
                    else:
                        if self._fused is None:
                            self._build_fused()
                        view, thr = slam.old_view(self.last_pose_old)
                        vec, comp = self._fused[0](
                            view, thr, self._t(self.last_pose_old),
                            slam.last_maps, slam.model_maps,
                            self._t(slam.last_increment),
                            slam.confidence_threshold())
                        fetch = AsyncFetch(vec)
                    v = np.asarray(fetch.wait())
                    inc_old = v[:16].reshape(4, 4)
                    log_old = v[16:22]
                    rstats = _host_stats(v[22:28])
                    cstats = _host_stats(v[28:34])
                    pose_old_new = v[34:50].reshape(4, 4)
                else:
                    old_maps = self._render_old(slam, self.last_pose_old)
                    res = icp_ops.gauss_newton(
                        slam.last_maps, old_maps,
                        self._t(slam.last_increment), self.cfg.icp,
                        self.cfg.model,
                        semantic=self.cfg.semantic.enabled)
                    inc_old, log_old, rstats = _fetch_gn(res.pose, res.stats)
                    pose_old_new = cstats = comp = None
                vr, orr, _ = self._ratios(rstats)
                inc_diff = float(np.linalg.norm(inc_log - log_old))
                verified_this_scan = False
                if vr > cfg.min_valid_ratio and orr < cfg.max_outlier_ratio \
                        and inc_diff < cfg.max_increment_difference:
                    if pose_old_new is None:
                        pose_old_new = self.last_pose_old @ inc_old
                        cstats = self._composed_residual(slam, pose_old_new,
                                                         pose)
                    else:
                        # composed view already rendered at pose_old_new by
                        # the program: reusable for composed tracking
                        self._last_comp = comp
                        self._last_comp_pose = pose_old_new
                    _, _, res_old = self._ratios(cstats)
                    verified_this_scan = self._accept_verification(
                        slam, ts, pose_old_new, res_old, res_new)
                stats["loop-verifying"] = verified_this_scan

            # ---- promotion -----------------------------------------------
            if not self.already_verified and \
                    len(self.unverified) >= cfg.min_verifications + 1:
                self.verified.extend(self.unverified)
                self.unverified.clear()
                self.already_verified = True
        # ---- add verified edges ------------------------------------------
        with span(sw, "loop/edges"):
            last_from = -1
            for cand in self.verified:
                if cand.frm != last_from:
                    last_from = cand.frm
                    self.loop_count += 1
                    self.num_loop_closures += 1
                self.posegraph.add_edge(cand.frm, cand.to, cand.rel_pose,
                                        self._info, robust=True)
            self.verified.clear()
        # ---- optimize ----------------------------------------------------
        with span(sw, "loop/opt"):
            # async (default): clone the graph and solve on a background host
            # thread, integrating the result on a later scan. The launch
            # itself is host-only, so it works at any pipeline lag.
            if (self.loop_count > 6) or \
                    (self.loop_count > 0 and self.time_without_loop > 3):
                if self.cfg.loop.async_optimize:
                    self._launch_optimize()
                elif lag > 0:
                    deferred = True
                else:
                    self._optimize_and_rebase(slam)
        # ---- phase C: search a new candidate -----------------------------
        with span(sw, "loop/search"):
            if self.time_without_loop > 3:
                self.unverified.clear()
                self.already_verified = False
                self._pose_old_dev = None  # next chain re-seeds the carry
                if lag > 0:
                    # the search ICP needs THIS scan's data maps on device;
                    # with scans in flight, only check the (host-side)
                    # trigger and ask the host loop to drain + re-enter
                    # synchronously: the search repeats next scan at lag 0
                    if self._closest_index(slam, info.pose) >= 0:
                        deferred = True
                else:
                    found = self._search_candidate(slam, info, vr_new, or_new,
                                                   res_new)
                    stats["loop-candidate-found"] = found
        # ---- composed old/new tracking while a candidate is live ---------
        with span(sw, "loop/compose"):
            # The model view for the NEXT scan's ICP is the composed old+new
            # map whenever a loop candidate is active, so odometry keeps
            # tracking against the old map through the verification window.
            if cfg.compose_rendering and qvec is None and lag == 0 \
                    and (self.unverified or self.already_verified):
                if self._last_comp is not None and np.array_equal(
                        self.pose_old, self._last_comp_pose):
                    # the verify program already composed old@pose_old with
                    # this scan's model render: reuse, no extra device work
                    slam.set_model_maps(self._last_comp)
                else:
                    old_maps = self._render_old(slam, self.pose_old)
                    slam.set_model_maps(sm.compose_views(
                        old_maps, slam.model_maps,
                        cfg.max_loop_closure_distance))
        self.sync_request = deferred
        stats["loop-count"] = self.loop_count
        stats["loop-closures"] = self.num_loop_closures
        return stats

    def _accept_verification(self, slam, ts: int, pose_old_new, res_old,
                             res_new) -> bool:
        """The gates passed: move the anchor to the ICP estimate and, if the
        composed residual is no worse than odometry's, record a candidate
        edge to the nearest old pose. Returns True if one was recorded."""
        cfg = self.cfg.loop
        rel_error = res_old / max(res_new, 1e-12)
        self.pose_old = pose_old_new
        if rel_error < cfg.residual_threshold or \
                (res_old - res_new) < cfg.residual_margin:
            self.time_without_loop = 0
            to = self._closest_index(slam, pose_old_new)
            if to > -1:
                cand = LoopClosureCandidate(
                    frm=ts, to=to,
                    rel_pose=np.linalg.inv(pose_old_new)
                    @ self.posegraph.pose(to))
                (self.verified if self.already_verified
                 else self.unverified).append(cand)
                return True
        return False

    # ------------------------------------------------------------------
    def _search_candidate(self, slam, info, vr_new, or_new, res_new) -> bool:
        cfg = self.cfg.loop
        ts = slam.timestamp - 1
        pose = np.asarray(info.pose)
        to = self._closest_index(slam, pose)
        if to < 0:
            return False

        pose_prior = self.posegraph.pose(to)
        fused = getattr(slam, "supports_fused_verify", False)
        old_maps = None
        if not fused:
            old_maps = self._render_old(slam, pose_prior)

        # three initializations
        O = np.linalg.inv(pose_prior) @ pose
        O[2, 3] = 0.0
        rot_only = O.copy()
        rot_only[:3, 3] = 0.0
        half = O.copy()
        half[0, 3] *= 0.5
        half[1, 3] *= 0.5

        # a candidate is pushed whenever the valid/outlier-ratio gates pass
        # for the best initialization; the residual test only decides
        # whether the old-frame pose anchor jumps to the ICP estimate (else
        # it stays at the odometry pose)
        fused_rows = None
        if fused:
            # all three initializations aligned + composed-evaluated in ONE
            # program with ONE fetch
            if self._fused is None:
                self._build_fused()
            view, thr = slam.old_view(pose_prior)
            fused_rows = np.asarray(AsyncFetch(self._fused[1](
                view, thr, self._t(pose_prior),
                self._t(np.stack([O, rot_only, half])),
                slam.last_maps, slam.model_maps,
                slam.confidence_threshold())).wait())
        best = None
        for k, init in enumerate((O, rot_only, half)):
            if fused_rows is not None:
                row = fused_rows[k]
                cand_pose = row[:16].reshape(4, 4)
                rstats = _host_stats(row[16:22])
                cstats = _host_stats(row[22:28])
                vr, orr, _ = self._ratios(rstats)
                if not (vr > cfg.min_valid_ratio
                        and orr < cfg.max_outlier_ratio):
                    continue
            else:
                res = self._align_candidate(slam.last_maps, old_maps, init)
                rel, _, rstats = _fetch_gn(res.pose, res.stats)
                vr, orr, _ = self._ratios(rstats)
                if not (vr > cfg.min_valid_ratio
                        and orr < cfg.max_outlier_ratio):
                    continue
                cand_pose = pose_prior @ rel
                cstats = self._composed_residual(slam, cand_pose, pose)
            vr_old, or_old, res_old = self._ratios(cstats)
            rel_valid = vr_old / max(vr_new, 1e-12)
            rel_outlier = or_old / max(or_new, 1e-12)
            rel_error = res_old / max(res_new, 1e-12)
            if rel_valid >= cfg.valid_threshold and \
                    rel_outlier < cfg.outlier_threshold:
                if best is None or (res_old < best[0] and or_old < best[1]):
                    accept = rel_error < cfg.residual_threshold or \
                        (res_old - res_new) < cfg.residual_margin
                    best = (res_old, or_old, cand_pose, accept)

        if best is None:
            return False
        _, _, cand_pose, accept = best
        anchor = cand_pose if accept else pose
        self.pose_old = anchor
        self.unverified.append(LoopClosureCandidate(
            frm=ts, to=to,
            rel_pose=np.linalg.inv(anchor) @ self.posegraph.pose(to)))
        return True

    # ------------------------------------------------------------------
    def _launch_optimize(self) -> None:
        """Launch the pose-graph solve on a background thread over a CLONE
        of the graph. One optimization in flight at a time; the scan loop
        keeps adding odometry/loop edges to the LIVE graph, which the next
        optimization picks up."""
        if self._opt_future is not None:
            return
        snap = self.posegraph.clone()
        self._opt_ts = len(snap._poses) - 1
        self._opt_before = snap.pose(self._opt_ts).copy()
        self.loop_count = 0
        kern = self.cfg.loop.robust_kernel
        delta = self.cfg.loop.robust_delta
        device = self._solve_device(snap.size())
        if self._executor is None:
            self._executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="posegraph-opt")

        def work():
            snap.optimize(robust_kernel=kern, robust_delta=delta,
                          device=device)
            return snap

        self._opt_future = self._executor.submit(work)

    def integrate(self, slam) -> bool:
        """Integrate a finished background optimization: merge the
        optimized clone into the live graph (poses tracked since the
        snapshot are rebased by ``difference = opt[snap] @ before^-1``),
        then either
        (a) correction below the rebase gates: update host poses only and
        fold the correction into ``slam.frame_correction`` (applied to
        every subsequently fetched device pose; the device map stays in
        its old frame within the gate bound), or (b) drain the pipeline
        and run the full device rebase (pose-table rewrite + model
        re-render). Host loops call this at dispatch boundaries when
        ``needs_integration``. Returns True if anything was integrated."""
        if self._opt_future is None or not self._opt_future.done():
            return False
        # the lap is named by the way it integrated: the profiler's range
        # keeps the name it opened with
        sw = getattr(slam, "stopwatch", None)
        with span(sw, "integrate") as done:
            return self._integrate(slam, done)

    def _integrate(self, slam, done) -> bool:
        snap = self._opt_future.result()
        self._opt_future = None
        self.num_optimizations += 1
        ts_snap = self._opt_ts
        difference = (snap.pose(ts_snap)
                      @ np.linalg.inv(self._opt_before)).astype(np.float32)
        # merge into the live graph
        live = self.posegraph._poses
        for i in range(len(live)):
            if i <= ts_snap:
                live[i] = snap.pose(i)
            else:
                live[i] = difference @ live[i]
        corr_old = getattr(slam, "frame_correction",
                           np.eye(4, dtype=np.float32))
        corr_new = (difference @ corr_old).astype(np.float32)

        # accumulated device<->output divergence AT the current pose
        cur_out = slam.poses[-1]
        cur_dev = np.linalg.inv(corr_old) @ cur_out
        moved = corr_new @ cur_dev
        t_acc = float(np.linalg.norm(moved[:3, 3] - cur_dev[:3, 3]))
        r_acc = float(np.arccos(np.clip(
            (np.trace(corr_new[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)))
        lcfg = self.cfg.loop
        if t_acc < lcfg.rebase_gate_translation \
                and r_acc < lcfg.rebase_gate_rotation:
            # (a) below-gate: host-only integration
            done.label = "integrate-soft"
            self.num_soft_integrations += 1
            slam.frame_correction = corr_new
            for i in range(min(len(live), len(slam.poses))):
                slam.poses[i] = live[i]
            self._rewrite_trajectory_distances(slam)
            if self.pose_old is not None:
                self.pose_old = difference @ self.pose_old
            return True
        # (b) full device rebase: needs an empty pipeline
        done.label = "integrate-rebase"
        self.num_rebases += 1
        slam.flush()
        opt = np.stack(self.posegraph.poses())
        new_current = difference @ np.asarray(slam.poses[-1])
        slam.rebase(opt, new_current)
        slam.frame_correction = np.eye(4, dtype=np.float32)
        self._pose_old_dev = None
        self.pose_old = new_current.copy()
        for i in range(min(len(opt), len(slam.poses))):
            slam.poses[i] = opt[i]
        self._rewrite_trajectory_distances(slam)
        return True

    def _rewrite_trajectory_distances(self, slam) -> None:
        dist = 0.0
        slam.trajectory_distances[0] = 0.0
        for i in range(1, len(slam.poses)):
            dist += float(np.linalg.norm(slam.poses[i][:3, 3]
                                         - slam.poses[i - 1][:3, 3]))
            if i < len(slam.trajectory_distances):
                slam.trajectory_distances[i] = dist
            else:  # pragma: no cover - defensive
                slam.trajectory_distances.append(dist)

    # ------------------------------------------------------------------
    def _optimize_and_rebase(self, slam) -> None:
        """Optimize the graph and rebase the live state (the synchronous
        version of ``integrate``). The device-side rewrite (pose table +
        world cache + model re-render) is the host loop's ``rebase``."""
        ts = slam.timestamp - 1
        before_pose = self.posegraph.pose(ts).copy()
        self.posegraph.optimize(
            robust_kernel=self.cfg.loop.robust_kernel,
            robust_delta=self.cfg.loop.robust_delta,
            device=self._solve_device(self.posegraph.size()))
        self.num_optimizations += 1
        self.loop_count = 0

        difference = self.posegraph.pose(ts) @ np.linalg.inv(before_pose)
        new_current = difference @ to_numpy(slam.pose)

        opt = np.stack(self.posegraph.poses())
        slam.rebase(opt, new_current)
        if hasattr(slam, "frame_correction"):
            slam.frame_correction = np.eye(4, dtype=np.float32)
        self._pose_old_dev = None

        # rewrite host pose log + trajectory distances
        for i in range(min(len(opt), len(slam.poses))):
            slam.poses[i] = self.posegraph.pose(i)
        self._rewrite_trajectory_distances(slam)
        self.pose_old = new_current.copy()


def to_numpy(x) -> np.ndarray:
    """A pose as a host array: one counted read for a device tensor."""
    if isinstance(x, torch.Tensor):
        return np.asarray(to_host(x), np.float32)
    return np.asarray(x)
