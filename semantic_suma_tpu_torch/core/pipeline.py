"""The per-scan SLAM pipeline (counterpart of
``semantic_suma_tpu/core/pipeline.py``): preprocess -> frame-to-model ICP ->
track-loss fallback -> map fusion -> model render, and the host loop with
its loop-closure wiring.

The JAX package compiles one device program per scan. Here the step runs
eagerly; its Gauss-Newton loops read nothing (``ops/icp``'s latched loop),
and it reads the host (``device.to_host``, counted in ``StepInfo.syncs``)
once, for its two branch flags, the track-loss jump and the view refresh,
read together with the new pose's rotation, which the host orthonormalizes
(once more on a scan whose fallback runs, at the recovered pose). The
creation append and the counts stay on the device (``core/surfel_map``).
``SurfelSLAM`` drives the step and, when enabled, the loop-closure state
machine and the host-RAM spill of the map arena (``core/spill``). With
``chunk_size=K`` and loop closure off, ``process_scan_async`` runs K scans
per dispatch (``odometry_chunk_fetch``) and reads their K packed result
rows with one fetch. On a card the step's stages are replayed as CUDA
graphs (``core/step_graph``), the same stage functions as the eager step
calls here, between the same host read.
"""

from __future__ import annotations

import time
from collections import deque
from contextlib import contextmanager
from dataclasses import replace
from typing import NamedTuple

import numpy as np
import torch

from ..config import SumaConfig
from ..device import AsyncFetch, resolve_device, to_host
from ..ops import icp as icp_ops
from ..ops.icp import Maps
from ..utils import lie
from ..utils.timing import Stopwatch, span
from . import surfel_map as sm
from .loop_closure import LoopCloser, OldMapRenderCache
from .preprocessing import empty_maps, preprocess_scan
from .spill import SpillManager


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
    iterations: torch.Tensor      # int32 on the device (sharded: an int)
    track_loss: bool              # the fallback alignment ran
    n_created: torch.Tensor
    n_dropped: torch.Tensor       # creations lost to an exhausted arena
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


def init_state(cfg: SumaConfig, device=None,
               reuse: SlamState | None = None) -> SlamState:
    """A session's first state; ``reuse``: a finished session's state of the
    same configuration, whose arena and active view it takes, zeroed
    (``surfel_map.empty_map``)."""
    dev = resolve_device(device)
    return SlamState(
        map=sm.empty_map(cfg.map, dev, None if reuse is None else reuse.map),
        pose=torch.eye(4, dtype=torch.float32, device=dev),
        last_increment=torch.eye(4, dtype=torch.float32, device=dev),
        last_maps=empty_maps(cfg, dev),
        model_maps=empty_maps(cfg, dev),
        timestamp=torch.zeros((), dtype=torch.int32, device=dev),
    )


def jump_flag(last_increment: torch.Tensor, increment: torch.Tensor, ts,
              icp_cfg) -> torch.Tensor:
    """The track-loss test as a device bool: the increment jumps w.r.t. the
    motion model (``ts > 1`` only)."""
    delta = lie.se3_inverse(last_increment) @ increment
    t_err = torch.linalg.norm(delta[:3, 3])
    r_err = lie.rotation_angle(delta)
    return (ts > 1) & ((t_err > icp_cfg.fallback_translation_jump)
                       | (r_err > icp_cfg.fallback_rotation_jump))


def pose_and_refresh(pose: torch.Tensor, increment: torch.Tensor, ts,
                     map_state: sm.MapState, cfg: SumaConfig, map_cfg=None,
                     max_creates: int | None = None):
    """``(increment, moved pose, refresh flag)`` of a step: the increment with
    the first scan's rule (no motion at ``ts == 0``), ``pose @ increment``
    before its rotation is orthonormalized (:func:`read_flags` does that),
    and ``surfel_map.refresh_needed`` of ``map_state`` at its position (a
    device bool; the projection keeps the translation), for the creations
    one scan can make (``max_creates`` a rank's share, in the sharded
    step)."""
    eye = torch.eye(4, dtype=torch.float32, device=pose.device)
    increment = torch.where(ts == 0, eye, increment)
    moved = pose @ increment
    hw = cfg.data.height * cfg.data.width
    need = sm.refresh_needed(map_state, moved[:3, 3],
                             cfg.map if map_cfg is None else map_cfg,
                             sm.creation_region_rows(hw, max_creates))
    return increment, moved, need


def flag_vector(jump: torch.Tensor | None, need: torch.Tensor,
                moved: torch.Tensor) -> torch.Tensor:
    """What :func:`read_flags` reads, on the device: ``[jump, need,
    moved's rotation (9)]`` in ``moved``'s type (the jump 0 when the
    fallback is off)."""
    dev = moved.device
    flags = torch.stack([torch.zeros((), dtype=torch.bool, device=dev)
                         if jump is None else jump, need])
    return torch.cat([flags.to(moved.dtype), moved[:3, :3].reshape(-1)])


def read_flag_vector(vec: torch.Tensor, moved: torch.Tensor):
    """The read of a :func:`flag_vector`: ``(jumped, refresh, new pose)``,
    the pose's rotation projected onto SO(3) on the host (see
    :func:`read_flags`) and its translation ``moved``'s."""
    dev = moved.device
    vals = to_host(vec)
    rot = lie.orthonormalize(lie.rt_to_mat(
        torch.tensor(vals[2:], dtype=moved.dtype).reshape(3, 3),
        torch.zeros(3, dtype=moved.dtype)))[:3, :3]
    if dev.type == "cuda":
        rot = rot.pin_memory().to(dev, non_blocking=True)
    return bool(vals[0]), bool(vals[1]), lie.rt_to_mat(rot, moved[:3, 3])


def read_flags(jump: torch.Tensor | None, need: torch.Tensor,
               moved: torch.Tensor):
    """The step's one read: ``(jumped, refresh, new pose)``. The jump flag
    (None when the fallback is off), the refresh flag and the rotation of
    ``moved`` come to the host together (:func:`flag_vector`); the rotation
    is projected onto SO(3) there by ``lie.orthonormalize`` (LAPACK's SVD,
    the JAX package's CPU answer: a CUDA SVD reads its convergence flags to
    the host, which would wait for the device once more), and goes back to
    the device by a non-blocking copy from pinned memory."""
    return read_flag_vector(flag_vector(jump, need, moved), moved)


@contextmanager
def _stage(stopwatch: Stopwatch | None, timer: StageTimer | None, device,
           name: str, first: bool = False):
    """The span ``step/<name>`` of one stage of :func:`odometry_step`; at its
    exit ``timer`` (when attached) marks the boundary that ends stage
    ``name`` (and, for the ``first`` stage, at its entry the step's
    start)."""
    with span(stopwatch, "step/" + name):
        if first and timer is not None:
            timer.mark(device, None)
        yield
        if timer is not None:
            timer.mark(device, name)


class Aligned(NamedTuple):
    """What the Gauss-Newton stage leaves for the host's read and the stages
    after it: the loop's result, the increment and the moved pose of
    :func:`pose_and_refresh`, and the :func:`flag_vector` the host reads."""

    result: icp_ops.IcpResult
    increment: torch.Tensor
    moved: torch.Tensor
    flags: torch.Tensor


def _t0(state: SlamState, cfg: SumaConfig) -> torch.Tensor:
    """Gauss-Newton's start: the identity or the motion model."""
    if cfg.icp.initialize_identity:
        return torch.eye(4, dtype=torch.float32, device=state.pose.device)
    return state.last_increment


def preprocess_stage(state: SlamState, points, labels, probs, point_valid,
                     cfg: SumaConfig) -> Maps:
    """The step's stage ``preprocess``: the scan's data maps."""
    return preprocess_scan(points, labels, probs, point_valid,
                           state.timestamp < cfg.semantic.init_scans, cfg)


def align_stage(state: SlamState, data_maps: Maps,
                cfg: SumaConfig) -> Aligned:
    """The stage ``gauss_newton`` up to the host's read: the alignment
    against the model (or the last frame), the increment, the moved pose,
    and the branch flags packed for the read: the track-loss fallback (the
    increment jumps w.r.t. the motion model: redo the alignment
    frame-to-frame with tighter gates) and the view refresh at the pose."""
    ts = state.timestamp
    ref_maps = state.model_maps if cfg.approach == "frame-to-model" \
        else state.last_maps
    result = icp_ops.gauss_newton(data_maps, ref_maps, _t0(state, cfg),
                                  cfg.icp, cfg.model,
                                  semantic=cfg.semantic.enabled)
    increment, moved, need = pose_and_refresh(state.pose, result.pose, ts,
                                              state.map, cfg)
    jump = jump_flag(state.last_increment, result.pose, ts, cfg.icp) \
        if cfg.icp.fallback_mode else None
    return Aligned(result, increment, moved, flag_vector(jump, need, moved))


def fuse_stage(state: SlamState, data_maps: Maps, new_pose: torch.Tensor,
               increment: torch.Tensor, refresh: bool, conf_threshold,
               cfg: SumaConfig, stopwatch: Stopwatch | None = None):
    """The stage ``fuse_render``: the scan's surfels fused at ``new_pose``
    and the model rendered there (``conf_threshold`` a number or a float32
    on the device). Returns ``(new_state, n_created, n_dropped)``."""
    ts = state.timestamp
    frame = sm.data_surfel_init(data_maps, cfg.data, cfg.map)
    new_map, model_maps, n_created, n_dropped = sm.fuse_and_render(
        state.map, frame, new_pose, ts, cfg.data, cfg.map, conf_threshold,
        (ts + 1) - cfg.loop.delta_timestamp, semantic=cfg.semantic.enabled,
        refresh=refresh, stopwatch=stopwatch)
    new_state = SlamState(map=new_map, pose=new_pose, last_increment=increment,
                          last_maps=data_maps, model_maps=model_maps,
                          timestamp=ts + 1)
    return new_state, n_created, n_dropped


class _Eager:
    """The stages called as they are. A ``core.step_graph.StepGraphs`` has
    the same methods and replays them as CUDA graphs."""

    @staticmethod
    def enter(state: SlamState) -> SlamState:
        return state

    preprocess = staticmethod(preprocess_stage)
    align = staticmethod(align_stage)
    fuse = staticmethod(fuse_stage)

    @staticmethod
    def pack(info: "StepInfo", block_count) -> torch.Tensor:
        return _pack_step_info(info, block_count)


_EAGER = _Eager()


def odometry_step(state: SlamState, points: torch.Tensor,
                  labels: torch.Tensor, probs: torch.Tensor,
                  point_valid: torch.Tensor, conf_threshold,
                  cfg: SumaConfig, timer: StageTimer | None = None,
                  stopwatch: Stopwatch | None = None, graphs=None):
    """Process one scan. Returns (new_state, StepInfo). The input state is
    consumed: its map arena and pose table are updated in place. The step
    reads the host once, for the branch flags (twice on a scan whose
    fallback runs). With a ``stopwatch`` its stages are the spans
    ``step/preprocess``, ``step/gauss_newton`` (holding ``step/flags``, each
    read of the flags) and ``step/fuse_render`` (holding
    ``surfel_map.fuse_and_render``'s ``fuse/*`` where it runs eagerly).

    ``graphs`` (a ``core.step_graph.StepGraphs``) runs the stages through
    its CUDA graphs: the state then lives in the graphs' buffers, and the
    returned state is those buffers, updated in place."""
    stages = _EAGER if graphs is None else graphs
    dev = state.pose.device
    reads0 = to_host.count
    state = stages.enter(state)

    with _stage(stopwatch, timer, dev, "preprocess", first=True):
        data_maps = stages.preprocess(state, points, labels, probs,
                                      point_valid, cfg)

    with _stage(stopwatch, timer, dev, "gauss_newton"):
        aligned = stages.align(state, data_maps, cfg)
        increment = aligned.increment
        with span(stopwatch, "step/flags"):
            jumped, refresh, new_pose = read_flag_vector(aligned.flags,
                                                         aligned.moved)
        if jumped:
            recovery_cfg = replace(cfg.icp,
                                   max_distance=cfg.icp.fallback_max_distance,
                                   max_angle=cfg.icp.fallback_max_angle)
            rec = icp_ops.gauss_newton(data_maps, state.last_maps,
                                       _t0(state, cfg), recovery_cfg,
                                       cfg.data, semantic=cfg.semantic.enabled)
            increment, moved, need = pose_and_refresh(
                state.pose, rec.pose, state.timestamp, state.map, cfg)
            with span(stopwatch, "step/flags"):
                _, refresh, new_pose = read_flags(None, need, moved)

    with _stage(stopwatch, timer, dev, "fuse_render"):
        new_state, n_created, n_dropped = stages.fuse(
            state, data_maps, new_pose, increment, refresh, conf_threshold,
            cfg, stopwatch)

    result = aligned.result
    info = StepInfo(pose=new_state.pose, increment=new_state.last_increment,
                    stats=result.stats, iterations=result.iterations,
                    track_loss=jumped, n_created=n_created,
                    n_dropped=n_dropped, map_count=new_state.map.count,
                    syncs=to_host.count - reads0)
    return new_state, info


def pack_results(pose, increment, stats: icp_ops.IcpStats, host_counts,
                 device_counts) -> torch.Tensor:
    """Everything the host loop needs of one scan, as ONE f32 vector [50] on
    the device. Layout: pose [0:16], increment [16:32], se3_log(increment)
    [32:38], then error, valid, inlier, outlier, inlier_residual, invalid,
    iterations, track_loss, n_created, n_dropped, map_count, block_count;
    the counters are ``host_counts`` followed by ``device_counts``, each a
    device value or a number (written by a fill kernel: an upload from
    pageable memory would wait for the device). All counters fit f32
    exactly (< 2^24)."""
    dev = pose.device
    inc = increment.to(torch.float32)

    def f32(x):
        if isinstance(x, torch.Tensor):
            return x.to(device=dev, dtype=torch.float32).reshape(())
        return torch.full((), float(x), dtype=torch.float32, device=dev)

    return torch.cat([
        pose.to(torch.float32).reshape(-1), inc.reshape(-1),
        lie.se3_log(inc).reshape(-1),
        torch.stack([f32(x) for x in (*stats, *host_counts,
                                      *device_counts)])])


def _pack_step_info(info: StepInfo, block_count) -> torch.Tensor:
    """:func:`pack_results` of one :func:`odometry_step`."""
    return pack_results(
        info.pose, info.increment, info.stats,
        [info.iterations, info.track_loss],
        [info.n_created, info.n_dropped, info.map_count, block_count])


def odometry_step_fetch(state: SlamState, points, labels, probs, point_valid,
                        conf_threshold, cfg: SumaConfig,
                        timer: StageTimer | None = None,
                        stopwatch: Stopwatch | None = None, graphs=None):
    """:func:`odometry_step` and the packing of its results: returns
    ``(new_state, packed[50])``, so that the host loop reads one vector a
    scan. With a ``stopwatch`` both are the span ``step``, the packing its
    child ``step/pack``. ``graphs``: as :func:`odometry_step`; the packed
    vector is then a buffer of the graphs that the next step rewrites, to
    be copied before it runs (``AsyncFetch`` enqueues its copy at once)."""
    with span(stopwatch, "step"):
        new_state, info = odometry_step(state, points, labels, probs,
                                        point_valid, conf_threshold, cfg,
                                        timer=timer, stopwatch=stopwatch,
                                        graphs=graphs)
        with span(stopwatch, "step/pack"):
            packed = (_EAGER if graphs is None else graphs).pack(
                info, new_state.map.block_count)
    return new_state, packed


def _stack(values):
    """Stack a list of like values (tensors, numbers or named tuples of
    them) along a new leading axis."""
    first = values[0]
    if isinstance(first, tuple):
        return type(first)(*(_stack(list(f)) for f in zip(*values)))
    if isinstance(first, torch.Tensor):
        return torch.stack(values)
    return torch.tensor(values)


def odometry_run(state: SlamState, points, labels, probs, point_valid,
                 conf_thresholds, cfg: SumaConfig):
    """Process a stacked batch of scans ``[T, ...]``: :func:`odometry_step`
    on each in turn. Returns ``(final state, StepInfo)`` with every field
    stacked over T (numbers as host tensors). Host work between scans (loop
    closure, spill paging, statistics) does not run inside a batch."""
    infos = []
    for i in range(points.shape[0]):
        state, info = odometry_step(state, points[i], labels[i], probs[i],
                                    point_valid[i], conf_thresholds[i], cfg)
        infos.append(info)
    return state, _stack(infos)


def odometry_chunk_fetch(state: SlamState, points, labels, probs,
                         point_valid, conf_thresholds, cfg: SumaConfig,
                         timer: StageTimer | None = None,
                         stopwatch: Stopwatch | None = None, graphs=None):
    """K scans (leading axis) in one dispatch -> ``(state, packed[K, 50])``:
    each scan's packed results (:func:`odometry_step_fetch`, through
    ``graphs`` where given) are written into one device tensor, which the
    host loop reads with one fetch. The steps' own host reads
    (``StepInfo.syncs``) still happen inside."""
    k = points.shape[0]
    infos = torch.empty((k, 50), dtype=torch.float32, device=points.device)
    for i in range(k):
        state, infos[i] = odometry_step_fetch(
            state, points[i], labels[i], probs[i], point_valid[i],
            conf_thresholds[i], cfg, timer=timer, stopwatch=stopwatch,
            graphs=graphs)
    return state, infos


def _pad_inputs(points, labels, probs, valid, n: int):
    """One scan's arrays zero-padded to ``n`` points: a pad row has point 0,
    label 0, probability 0 and ``valid`` False, so that the projection never
    sees it."""
    def pad(a):
        return torch.nn.functional.pad(a, (0, 0) * (a.dim() - 1)
                                       + (0, n - a.shape[0]))
    return pad(points), pad(labels), pad(probs), pad(valid)


def _stack_padded(scans, n: int):
    """Stack scans' ``(points, labels, probs, valid)`` along a new leading
    axis, each padded to ``n`` points by :func:`_pad_inputs`."""
    return tuple(torch.stack(col)
                 for col in zip(*(_pad_inputs(*s, n) for s in scans)))


class HostStepInfo(NamedTuple):
    """StepInfo with numpy leaves (free host reads) + extras from the packed
    fetch."""

    pose: np.ndarray
    increment: np.ndarray
    inc_log: np.ndarray
    stats: icp_ops.IcpStats
    iterations: int
    track_loss: bool
    n_created: int
    n_dropped: int
    map_count: int
    block_count: int


def _unpack_step_info(vec: np.ndarray) -> HostStepInfo:
    t = vec[32:]
    return HostStepInfo(
        pose=vec[:16].reshape(4, 4).copy(),
        increment=vec[16:32].reshape(4, 4).copy(),
        inc_log=t[:6].copy(),
        stats=icp_ops.IcpStats(error=float(t[6]), valid=float(t[7]),
                               inlier=float(t[8]), outlier=float(t[9]),
                               inlier_residual=float(t[10]),
                               invalid=float(t[11])),
        iterations=int(t[12]), track_loss=bool(t[13] > 0),
        n_created=int(t[14]), n_dropped=int(t[15]),
        map_count=int(t[16]), block_count=int(t[17]))


class HostLoop:
    """The host loop that the single-device session (:class:`SurfelSLAM`)
    and the sharded one (``parallel.sharding.ShardedSurfelSLAM``) share:
    the pose log and the statistics, the confidence schedule, the input
    coercion, the page-in, and the drain of one scan's packed results
    (:func:`pack_results`) through the near-capacity policy and the loop
    closer. A session holds its map behind ``_map`` / ``_put_map``, runs its
    step in ``_step``, and says in ``_agreed`` whether a flag holds for the
    whole session (for the sharded one: on any rank)."""

    # the near-capacity policy's asynchronous eligibility probe (its
    # verdict lands a scan later, so a session whose decisions must agree
    # across ranks scores synchronously)
    async_probe = True
    # compaction under pressure: when the live count nears the capacity (the
    # JAX package's single-device rule), or when the free rows fall under
    # the headroom (its sharded rule). A session without spill always takes
    # the second: compaction is its only reclaim, and the arena runs out of
    # free blocks (dead rows and the eager fresh region count) while the
    # live count still looks far from the capacity; with few scans in
    # flight (after a rebase's flush) the first rule then let a scan's
    # creations drop.
    compact_on_free_rows = False

    def __init__(self, cfg: SumaConfig, map_cfg, scan_rows: int, device,
                 pipeline_depth: int, enable_loop_closure: bool | None):
        self.cfg = cfg
        # the configuration of the arena this session holds (a shard's for
        # the sharded session), and the rows one scan can create in it
        self.map_cfg = map_cfg
        self.scan_rows = scan_rows
        self.device = device
        self.pipeline_depth = max(0, pipeline_depth)
        self._pending: "deque" = deque()
        self._drain_rest = 0  # rows of the chunk in drain after this one
        self._dispatched = 0
        self._spill_retry_blocks = 0
        # host-visible phases on the host clock
        self.stopwatch = Stopwatch()
        # called with every finished scan's stats dict (pipelined draining
        # completes several scans per call, so return values alone
        # under-report)
        self.stats_callback = None
        self.poses: list = []
        self.statistics: list = []
        self.trajectory_distances: list = [0.0]
        self.track_loss_count = 0
        self.map_version = 0  # bumped on page-in, spill, compaction, rebase
        # whether a page-in moves map_version
        self.paging_moves_version = True
        self.creations_dropped = 0
        self.syncs = 0
        # device-frame -> output-frame pose correction: identity except
        # after a below-gate integration deferred the device rebase
        # (LoopCloser.integrate); applied to every fetched pose so the
        # exported trajectory is always the optimized one
        self.frame_correction = np.eye(4, dtype=np.float32)
        self._old_cache = None
        self.spill = None
        if cfg.map.spill_enabled:
            self.spill = SpillManager(
                map_cfg, chunk_blocks=cfg.map.spill_chunk_blocks,
                spill_margin=cfg.map.spill_margin,
                unspill_margin=cfg.map.unspill_margin)
        self._loop = None
        do_loops = cfg.loop.enabled if enable_loop_closure is None \
            else enable_loop_closure
        if do_loops and cfg.approach == "frame-to-model":
            self._loop = LoopCloser(cfg, device=device)

    # -- what a session provides --------------------------------------------
    @property
    def _map(self) -> sm.MapState:
        raise NotImplementedError

    def _put_map(self, new_map: sm.MapState) -> None:
        raise NotImplementedError

    def _step(self, points, labels, probs, point_valid, conf_threshold):
        """Run one scan's device step; returns (packed results, host reads
        the step made)."""
        raise NotImplementedError

    def _agreed(self, flag: bool) -> bool:
        return flag

    # -- shared host state ---------------------------------------------------
    @property
    def timestamp(self) -> int:
        return len(self.poses)

    def trajectory(self) -> np.ndarray:
        return np.stack(self.poses) if self.poses else np.zeros((0, 4, 4))

    def _conf_at(self, t: int) -> float:
        """Confidence warmup schedule at scan ``t``."""
        cfg = self.cfg.map
        if t < cfg.time_init:
            a = t / cfg.time_init
            return (1.0 - a) * cfg.log_unstable + a * cfg.confidence_threshold
        return cfg.confidence_threshold

    def confidence_threshold(self) -> float:
        """The schedule at the current DISPATCH count (equals len(poses) in
        sync mode; runs ahead of it while scans are in flight)."""
        return self._conf_at(self._dispatched)

    def _set_map(self, new_map) -> None:
        """Install a map that a page-in, spill or compaction produced."""
        self._put_map(new_map)
        self.map_version += 1

    def _page_in(self, center) -> None:
        """Bring spilled chunks near ``center`` back onto the device, each
        only if the creations of the scans that run before the next drain,
        ``(1 + lag)`` scans' rows, still fit behind it (the JAX package
        pages in up to the last block; ROADMAP section 3)."""
        if self.spill is None:
            return
        st = self.spill.ensure_resident(
            self._map, center,
            headroom_rows=(1 + self._inflight()) * self.scan_rows)
        if st is not None:
            self._put_map(st)
        if self.paging_moves_version and self._agreed(st is not None):
            self.map_version += 1

    # -- dispatch / drain split -------------------------------------------
    # ``_dispatch`` runs the step and starts the copy of its packed info
    # vector to the host; ``_drain_one`` completes the host bookkeeping of
    # the oldest dispatch, one scan or the K scans of a chunk
    # (``SurfelSLAM(chunk_size=K)``). ``process_scan`` is fully synchronous
    # (the loop-closure state machine gets the result before the next scan);
    # ``process_scan_async`` keeps up to ``pipeline_depth`` dispatches' host
    # bookkeeping outstanding.

    def _prep_scan(self, points, labels, probs, point_valid):
        """One scan's inputs as device tensors (defaults filled in) and its
        confidence threshold, fixed at this dispatch count. Returns
        ``(points, labels, probs, valid, conf_threshold)``."""
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
        ct = self._conf_at(self._dispatched)
        self._dispatched += 1
        return points, labels, probs, point_valid, ct

    def _dispatch(self, points, labels, probs, point_valid) -> None:
        self._dispatch_prepped(self._prep_scan(points, labels, probs,
                                               point_valid))

    def _dispatch_prepped(self, prepped) -> None:
        t_start = time.perf_counter()
        packed, step_syncs = self._step(*prepped)
        self._pending.append((AsyncFetch(packed), t_start, step_syncs, 1))
        self.stopwatch.record("dispatch", time.perf_counter() - t_start)

    def _inflight(self) -> int:
        """Scans dispatched whose results the host has not processed yet,
        excluding the one being drained: the pending dispatches' scans and
        the scans of the chunk being drained that come after it (the device
        ran them already)."""
        return sum(e[3] for e in self._pending) + self._drain_rest

    def _drain_one(self) -> dict:
        fetch, t_start, step_syncs, rows = self._pending.popleft()
        with self.stopwatch.span("fetch-wait"):
            vec = fetch.wait()  # the host loop's one blocking read a dispatch
        self.syncs += step_syncs + 1
        if rows == 1:
            return self._finish_host(vec, t_start)
        stats = None
        for r in range(rows):
            self._drain_rest = rows - 1 - r
            stats = self._finish_host(vec[r], t_start)
        self._drain_rest = 0
        return stats

    def _finish_host(self, vec: np.ndarray, t_start: float) -> dict:
        """The host's part of one scan, the span ``finish``: the k-th
        ``finish`` of a session belongs to its k-th ``step``."""
        with self.stopwatch.span("finish"):
            return self._finish_scan(vec, t_start)

    def _finish_scan(self, vec: np.ndarray, t_start: float) -> dict:
        sw = self.stopwatch
        info = _unpack_step_info(vec)
        # map device-frame poses to the output frame (identity unless a
        # below-gate integration deferred the device rebase)
        info = info._replace(pose=self.frame_correction @ info.pose)
        lag = self._inflight()  # scans dispatched after this one

        # near-capacity policy: first page far blocks to host RAM, then fall
        # back to stream compaction. A non-zero drop count means the arena
        # filled before the host got ahead of it: reclaim at once, so that
        # at most one scan drops, and count what was lost. In pipelined mode
        # the fetched counters lag by ``lag`` scans, so every headroom test
        # widens by lag scans' rows (worst-case growth).
        cap = self.map_cfg.surfel_capacity
        rows = self.scan_rows
        n_dropped = info.n_dropped
        self.creations_dropped += n_dropped
        pose = info.pose
        free_rows = cap - info.block_count * self.map_cfg.effective_block_size
        headroom = (2 + lag) * rows
        pressure = free_rows < headroom or bool(n_dropped)
        spilled = False      # this session's map (rank's shard) spilled
        spilled_any = False  # ... on any rank
        if self.spill is not None:
            with sw.span("host/page-in"):
                self._page_in(pose[:3, 3])
            # a futile attempt (under pressure, nothing beyond the keep
            # radius) must not repeat every scan: retry only after the arena
            # grew by a chunk
            if pressure and info.block_count >= self._spill_retry_blocks:
                # the lap is named by what the attempt did: the profiler's
                # range keeps the name it opened with
                with sw.span("spill") as attempt:
                    # the asynchronous probe pays only with scans in flight
                    # (its copy hides behind them); lag 0 scores at once,
                    # and active dropping always reclaims now
                    st = self.spill.maybe_spill(
                        self._map, pose[:3, 3], headroom_rows=headroom,
                        async_probe=(self.async_probe and not n_dropped
                                     and lag > 0),
                        version=self.map_version)
                    if st is not None:
                        self._put_map(st)  # maybe_spill compacts
                        spilled = True
                    spilled_any = self._agreed(spilled)
                    attempt.label = ("host/spill-out" if spilled_any
                                     else "host/spill-probe")
                    if spilled_any:
                        self._spill_retry_blocks = 0
                    elif not self.spill.probe_pending:
                        # futile verdict (probe or synchronous path): do not
                        # score again until the arena grows a chunk; while
                        # the probe is in flight, leave the threshold unset
                        # so that its verdict is read next scan
                        self._spill_retry_blocks = (info.block_count
                                                    + self.spill.chunk_blocks)
        with sw.span("host/spill-compact"):
            compact = bool(n_dropped) or (
                pressure if self.compact_on_free_rows or self.spill is None
                else info.map_count + (1 + lag) * rows > cap)
            if compact and not spilled:
                self._put_map(sm.compact(self._map, self.map_cfg))
            if compact or spilled_any:
                self.map_version += 1
        with sw.span("host/bookkeep"):
            self.poses.append(pose)
            if len(self.poses) > 1:
                self.trajectory_distances.append(
                    self.trajectory_distances[-1]
                    + float(np.linalg.norm(self.poses[-2][:3, 3]
                                           - pose[:3, 3])))
            self.track_loss_count += int(info.track_loss)

            stats = {
                "icp-iterations": info.iterations,
                "icp-error": info.stats.error,
                "icp-inlier": int(info.stats.inlier),
                "icp-outlier": int(info.stats.outlier),
                "icp-valid": int(info.stats.valid),
                "icp-invalid": int(info.stats.invalid),
                "track-loss": info.track_loss,
                "map-count": info.map_count,
                "surfels-created": info.n_created,
                "creations-dropped": n_dropped,
            }
        if self._loop is not None:
            # the closer's span ``loop`` (on every scan but the first)
            stats.update(self._loop.on_scan(self, info, lag=self._inflight()))

        # from the scan's dispatch on, across calls: a lap, not a span
        stats["complete-time"] = time.perf_counter() - t_start
        sw.record("complete", stats["complete-time"])
        self.statistics.append(stats)
        if self.stats_callback is not None:
            self.stats_callback(stats)
        return stats


class SurfelSLAM(HostLoop):
    """Host-side loop: owns the device state, the pose log, the statistics,
    the host-RAM spill of the arena (``cfg.map.spill_enabled``) and (when
    enabled) the loop-closure state machine. Runs on the card unless the
    caller names another device. ``chunk_size=K`` batches K scans a
    dispatch in ``process_scan_async`` when loop closure is off.

    On a card the step runs through ``core.step_graph.StepGraphs``: the
    state lives in the graphs' buffers and is updated in place, scan after
    scan, and a session that is collected hands graphs and buffers to the
    next session of its configuration, which reuses its arena. Keep a
    session, not only its ``state``, for as long as its device state is
    read."""

    # the LoopCloser uses the one-fetch verification/search programs here
    supports_fused_verify = True

    def __init__(self, cfg: SumaConfig, enable_loop_closure: bool | None = None,
                 pipeline_depth: int = 4, chunk_size: int = 1, device=None):
        dev = resolve_device(device)
        super().__init__(cfg, cfg.map, cfg.data.height * cfg.data.width, dev,
                         pipeline_depth, enable_loop_closure)
        # the step's stages as CUDA graphs on a card (core/step_graph): the
        # state then lives in their buffers. A finished session of the same
        # configuration hands its graphs and buffers on to the next, whose
        # first state takes that session's arena and active view
        self._graphs = None
        if self.device.type == "cuda":
            from .step_graph import StepGraphs
            self._graphs = StepGraphs.for_session(self)
        self.state = init_state(
            cfg, self.device,
            reuse=None if self._graphs is None else self._graphs.state)
        # scans a dispatch of process_scan_async (loop closure off), and the
        # prepared scans waiting for their chunk
        self.chunk_size = max(1, chunk_size)
        self._chunk_buf: list = []
        # device time per stage of the step, when set
        self.timer: StageTimer | None = None
        self._verify_cache = None
        if self._loop is not None:
            # this host loop supports the device-carried verification chain
            self._loop.pipelined_ok = cfg.loop.pipelined_verification
        # reduced read-only view for the chained per-scan verification
        # (cfg.loop.verify_view_fraction of the active blocks around the loop
        # site): the verify program renders the old view twice per scan, and
        # the render's cost grows with the view's rows
        k_blocks = cfg.map.active_capacity // cfg.map.effective_block_size
        vb = max(1, int(k_blocks * cfg.loop.verify_view_fraction))
        self._verify_blocks = min(vb, k_blocks)

    @property
    def _map(self) -> sm.MapState:
        return self.state.map

    def _put_map(self, new_map: sm.MapState) -> None:
        self.state = self.state._replace(map=new_map)
        self._install()

    def _install(self) -> None:
        """Copy a state the host replaced into the step graphs' buffers at
        once, so that the replaced tensors are freed as soon as they would
        be without graphs."""
        if self._graphs is not None and self._graphs.state is not None:
            self.state = self._graphs.enter(self.state)

    def _step(self, points, labels, probs, point_valid, conf_threshold):
        reads0 = to_host.count
        self.state, packed = odometry_step_fetch(
            self.state, points, labels, probs, point_valid, conf_threshold,
            self.cfg, timer=self.timer, stopwatch=self.stopwatch,
            graphs=self._graphs)
        return packed, to_host.count - reads0

    def _dispatch_chunk(self) -> None:
        """Run the buffered scans as one chunk (:func:`odometry_chunk_fetch`,
        stacked to the largest point count); a partial chunk (the end of a
        sequence) goes out scan by scan."""
        entries, self._chunk_buf = self._chunk_buf, []
        if len(entries) < self.chunk_size:
            for e in entries:
                self._dispatch_prepped(e)
            return
        t_start = time.perf_counter()
        nmax = max(e[0].shape[0] for e in entries)
        pts, lab, prb, val = _stack_padded([e[:4] for e in entries], nmax)
        reads0 = to_host.count
        self.state, infos = odometry_chunk_fetch(
            self.state, pts, lab, prb, val, [e[4] for e in entries],
            self.cfg, timer=self.timer, stopwatch=self.stopwatch,
            graphs=self._graphs)
        self._pending.append((AsyncFetch(infos), t_start,
                              to_host.count - reads0, len(entries)))
        self.stopwatch.record("dispatch", time.perf_counter() - t_start)

    def _inflight(self) -> int:
        """As ``HostLoop._inflight``, and the scans buffered for a chunk."""
        return super()._inflight() + len(self._chunk_buf)

    # accessors the LoopCloser reads instead of unpacking SlamState
    @property
    def pose(self):
        return self.state.pose

    @property
    def last_maps(self):
        return self.state.last_maps

    @property
    def last_increment(self):
        return self.state.last_increment

    @property
    def model_maps(self):
        return self.state.model_maps

    def set_model_maps(self, maps) -> None:
        self.state = self.state._replace(model_maps=maps)
        self._install()

    # -- out-of-band map operations (loop closure, rebase, compaction) -----
    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def _build_old_view(self, center, thr):
        return sm.refresh_active(self.state.map, self._tensor(center),
                                 self.cfg.map, priority="old",
                                 ts_threshold=thr).active

    def _build_verify_view(self, center, thr):
        return sm.build_view(self.state.map, self._tensor(center),
                             self.cfg.map, self._verify_blocks,
                             ts_threshold=thr)

    def _render_old_view(self, view, pose, conf, thr):
        return sm.render_view(view, self._tensor(pose), self.cfg.model,
                              self.cfg.map, conf, thr, "old")

    def compact_map(self) -> None:
        self._set_map(sm.compact(self.state.map, self.cfg.map))

    def _ready_old_cache(self, view_pose):
        # the old map a revisit needs may have been paged out: bring the
        # chunks near the view back before rendering it
        self._page_in(np.asarray(view_pose)[:3, 3])
        if self._old_cache is None:
            self._old_cache = OldMapRenderCache(
                build_view=self._build_old_view,
                render_view=self._render_old_view,
                delta_timestamp=self.cfg.loop.delta_timestamp)
        return self._old_cache

    def old_view(self, view_pose, timestamp: int | None = None):
        """Cached old-map device VIEW around ``view_pose`` -> (view, thr);
        input to the LoopCloser's verify/search programs. ``timestamp``
        defaults to the drain count; dispatch-time callers pass their
        explicit dispatch count so that pre-dispatched and drain-time
        verification use identical ts thresholds."""
        return self._ready_old_cache(view_pose).view_for(
            view_pose, self.timestamp if timestamp is None else timestamp,
            self.map_version)

    def verify_view(self, view_pose, timestamp: int):
        """Reduced old view for the chained per-scan verification (the
        candidate search keeps the full view). The full cache when
        verify_view_fraction >= 1."""
        if self._verify_blocks * self.cfg.map.effective_block_size \
                >= self.cfg.map.active_capacity:
            return self.old_view(view_pose, timestamp)
        if self._verify_cache is None:
            # wider motion bound than the full cache: the verify view is
            # rendered through the verification gates (which tolerate the
            # extra staleness), and each rebuild stalls the chained verify
            self._verify_cache = OldMapRenderCache(
                build_view=self._build_verify_view,
                render_view=self._render_old_view,
                delta_timestamp=self.cfg.loop.delta_timestamp,
                motion_bound=12.0)
        # no spill page-in here (unlike _ready_old_cache): this runs at
        # DISPATCH time, before the drain's headroom test can make room, so a
        # page-in here could fill the arena and drop creations. The chain's
        # start (the candidate search) goes through old_view at lag 0 and
        # pages the old map in there; during a chain the anchor stays near
        # the vehicle, whose surroundings are never evicted (keep radius).
        return self._verify_cache.view_for(view_pose, timestamp,
                                           self.map_version)

    def render_old_maps(self, view_pose):
        """Cached old-(inactive-)map render at ``view_pose``."""
        return self._ready_old_cache(view_pose).render(
            view_pose, self.timestamp, self.confidence_threshold(),
            self.map_version)

    def rebase(self, new_poses: np.ndarray, new_current: np.ndarray) -> None:
        """Rewrite the pose table (only poses change, surfels stay in their
        creation frames) and re-render the model view at the corrected
        pose."""
        table = self.state.map.poses.clone()
        m = min(len(new_poses), table.shape[0])
        table[:m] = self._tensor(np.asarray(new_poses)[:m])
        cur = self._tensor(new_current)
        new_map = sm.update_poses(self.state.map, table, self.cfg.map)
        model_maps = sm.render_maps(
            new_map, cur, self.cfg.model, self.cfg.map,
            self.confidence_threshold(),
            self.timestamp - self.cfg.loop.delta_timestamp, render_old=False)
        self.state = self.state._replace(map=new_map, pose=cur,
                                         model_maps=model_maps)
        self._install()
        for i in range(min(len(new_poses), len(self.poses))):
            self.poses[i] = np.asarray(new_poses[i])
        if self.spill is not None and self.spill.chunks:
            self.spill.on_rebase(AsyncFetch(table).wait())
        self.map_version += 1

    def process_scan(self, points, labels=None, probs=None, point_valid=None):
        """Feed one scan; returns its statistics dict. Fully synchronous:
        the result belongs to THIS scan."""
        self._dispatch(points, labels, probs, point_valid)
        if self._loop is not None:
            if self._loop.chain_live and self._loop.pipelined_ok:
                self._loop.dispatch_verify(self, self._dispatched - 1)
            else:
                self._loop.pre_dispatch(self)
        out = self._drain_one()
        if self._loop is not None and self._loop._opt_future is not None:
            # synchronous mode keeps the reference's ordering: an
            # optimization launched by this scan integrates before the next
            # scan (the background thread only hides the solve in the
            # pipelined path)
            self._loop._opt_future.result()
            self._loop.integrate(self)
        return out

    def process_scan_async(self, points, labels=None, probs=None,
                           point_valid=None):
        """Pipelined path: dispatches this scan and completes the
        host bookkeeping of the scan dispatched ``pipeline_depth`` scans ago
        (returns its stats dict, or None while the pipeline fills).

        What it hides here: ``odometry_step`` itself still reads the host
        (the Gauss-Newton stopping test every iteration, then the branch
        flags), so a dispatch returns only after the step's Gauss-Newton
        work; the fusion and render are left queued, and the last fetch of a
        scan and its host bookkeeping are deferred. The loop-closure protocol
        is the reference's all the same: a live candidate chain stays
        pipelined (verification is a per-scan device program whose pose_old
        anchor is CARRIED ON DEVICE between dispatches,
        ``LoopCloser.dispatch_verify``),
        the graph optimization runs on a background thread with deferred
        integration, and the pipeline drains only for a candidate SEARCH and
        for above-gate rebases. Call :meth:`flush` after the last scan.

        With ``chunk_size=K`` and loop closure off, scans are buffered and
        dispatched K at a time (:func:`odometry_chunk_fetch`), and a drain
        completes the K scans of the oldest chunk (returning the last one's
        stats dict)."""
        if self._loop is not None and self._loop.needs_integration:
            self._loop.integrate(self)  # drains internally if it rebases
        if self._loop is None and self.chunk_size > 1:
            # odometry only: chunk_size scans a dispatch, drained K at a time
            self._chunk_buf.append(self._prep_scan(points, labels, probs,
                                                   point_valid))
            if len(self._chunk_buf) >= self.chunk_size:
                self._dispatch_chunk()
            out = None
            while len(self._pending) > self.pipeline_depth:
                out = self._drain_one()
            return out
        self._dispatch(points, labels, probs, point_valid)
        if self._loop is not None:
            if self._loop.chain_live and self._loop.pipelined_ok:
                self._loop.dispatch_verify(self, self._dispatched - 1)
                if self._loop.sync_needed:  # deferred search pending
                    return self.flush()
            elif self._loop.sync_needed:
                self._loop.pre_dispatch(self)
                return self.flush()
        if len(self._pending) > self.pipeline_depth:
            return self._drain_one()
        return None

    def flush(self):
        """Dispatch the scans buffered for a chunk and drain all in-flight
        scans; then integrate any finished (or still running: the call waits
        for it) background graph optimization. Returns the last stats dict
        or None."""
        self._dispatch_chunk()
        out = None
        while self._pending:
            out = self._drain_one()
        if self._loop is not None and self._loop._opt_future is not None:
            self._loop._opt_future.result()
            self._loop.integrate(self)
        return out

    def finalize(self):
        """End-of-sequence: drain, then run one FINAL pose-graph solve over
        every accumulated edge and integrate it, so the exported trajectory
        reflects ALL loop closures (mid-run the solver only launches every
        ~7 closures, leaving the edges since the last launch unsolved). Safe
        to call several times and on a run of zero scans; not called from
        the per-scan path."""
        out = self.flush()
        lp = self._loop
        if lp is not None and self.timestamp > 0 \
                and len(lp.posegraph._edges) > self.timestamp - 1:
            # loop edges exist beyond the odometry chain: solve them all
            lp._launch_optimize()
            if lp._opt_future is not None:
                lp._opt_future.result()
                lp.integrate(self)
        return out
