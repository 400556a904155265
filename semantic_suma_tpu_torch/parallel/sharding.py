"""The sharded SLAM pipeline and data-parallel segmenter training (counterpart
of ``semantic_suma_tpu/parallel/sharding.py``).

The JAX package runs one ``shard_map`` program over a device mesh. Here each
shard is a process ("rank", ``parallel/distributed``) that runs the same
steps on its own part of the map and meets the other ranks in collectives:

* **Surfel-map block sharding** (``map`` axis): every rank owns a whole
  block-paged ``MapState`` (arena, active view, fresh region; paging, spill
  and compaction stay on the rank). The scan is replicated; pixel ``p``
  creates its surfel on rank ``p % D``.
* **ICP reduction**: each rank linearizes its ``H/D`` image rows (kernel
  D) and the partial sums of the products and the statistics are summed
  over the ranks once per Gauss-Newton iteration, so every rank takes the
  same step (kernel E; ``ops.icp.gauss_newton_sharded``).
* **Rendering**: every rank renders its shard; the candidates merge by
  depth (a gather and an argmin over the ranks, the lowest rank on a tie).
* **Segmenter**: data-parallel training over the ``data`` axis that
  computes the single-device function of the global batch: batch norm with
  the global batch's statistics, the loss over the global weight sum, the
  gradients summed over the ranks. On a ``("data", "model")`` mesh
  (:func:`make_2d_mesh`) the widest kernels' output channels are split over
  ``model`` as well (column-parallel convolutions, ``models/rangenet``).

**Lockstep.** A rank that enters a collective alone hangs the group, so every
branch that has a collective behind it is taken on replicated values: the
step's stopping test and fallback read values summed over the ranks; the
near-capacity policy (``core.pipeline.HostLoop``, shared with the
single-device session) reads the largest block count and the summed drops
of the ranks, and its spill's futile-retry threshold moves on the max over
the ranks of "this rank spilled"; a page-in on any rank moves
``map_version`` on every rank through a max over the group (JAX's
single-process rule; ``single_process=False`` keeps JAX's multi-process
rule, where page-ins never move it); and a background pose-graph solve is
integrated only once every rank's solve has ended, with rank 0's solution
broadcast to all.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from ..config import SumaConfig
from ..core import surfel_map as sm
from ..core.pipeline import (HostLoop, jump_flag, pack_results,
                             pose_and_refresh, read_flags)
from ..core.preprocessing import empty_maps, preprocess_scan
from ..device import resolve_device, to_host
from ..ops import icp as icp_ops
from ..ops.icp import Maps
from . import distributed
from .distributed import Group


@dataclass
class Mesh:
    """One rank's view of the mesh: the group of all its ranks, the axis
    names, its device, and for each axis the group of the ranks that share
    this rank's place on every other axis."""

    group: Group
    axis_names: tuple
    device: torch.device
    axes: dict

    @property
    def rank(self) -> int:
        return self.group.rank

    @property
    def size(self) -> int:
        return self.group.size


def _mesh_device(device) -> torch.device:
    if device is not None:
        return torch.device(device)
    if distributed.rank_device() is not None:
        return distributed.rank_device()
    return resolve_device(None)


def _world(n: int) -> Group:
    group = Group.world()
    if n != group.size:
        raise ValueError(f"a mesh of {n} devices needs that many ranks; the "
                         f"group has {group.size}")
    return group


def make_mesh(n_devices: int | None = None, axis: str = "map",
              device=None) -> Mesh:
    """The mesh of the initialized process group (every rank, on the device
    ``distributed.initialize`` gave it), or of this process alone when no
    group is up (``device``: the card unless named)."""
    group = Group.world() if n_devices is None else _world(n_devices)
    return Mesh(group, (axis,), _mesh_device(device), {axis: group})


def make_2d_mesh(n_data: int, n_model: int, device=None) -> Mesh:
    """The ``("data", "model")`` mesh of the initialized process group of
    ``n_data * n_model`` ranks: rank r sits at ``(r // n_model, r %
    n_model)``, the JAX package's row-major ``reshape(n_data, n_model)`` of
    its devices. A rank's ``data`` group is its column (the ranks of its
    model index), its ``model`` group its row. Every rank creates every
    subgroup in the same order: all the columns, then all the rows."""
    group = _world(n_data * n_model)
    if group.pg is None:
        axes = {"data": group, "model": group}
    else:
        n = n_data * n_model
        axes = {"data": Group.subgroups(
                    [list(range(c, n, n_model)) for c in range(n_model)]),
                "model": Group.subgroups(
                    [list(range(r * n_model, (r + 1) * n_model))
                     for r in range(n_data)])}
    return Mesh(group, ("data", "model"), _mesh_device(device), axes)


def shard_map_config(cfg: SumaConfig, ndev: int):
    """Per-rank MapConfig: the arena, the active view and the fresh region
    divide over the ranks."""
    hw = cfg.data.height * cfg.data.width
    return replace(cfg.map,
                   surfel_capacity=max(cfg.map.surfel_capacity // ndev,
                                       4096),
                   active_capacity=max(cfg.map.active_capacity // ndev,
                                       4096),
                   min_fresh_rows=sm.creation_region_rows(hw, -(-hw // ndev)))


# ---------------------------------------------------------------------------
# the sharded step and the out-of-band programs
# ---------------------------------------------------------------------------

def _rows(maps: Maps, lo: int, n: int) -> Maps:
    return Maps(*(a[lo:lo + n] for a in maps))


def sharded_step(cfg: SumaConfig, mcfg, mesh: Mesh, local: sm.MapState,
                 pose, last_inc, last_maps: Maps, model_maps: Maps, ts: int,
                 points, labels, probs, point_valid, conf_threshold):
    """One scan on this rank (the step of JAX's ``make_sharded_step``):
    replicated preprocessing, Gauss-Newton on this rank's ``H/D`` image rows
    with the sums over the ranks, the track-loss fallback, and fusion of
    this rank's shard with the merges of ``fuse_and_render``.

    Returns ``(local, pose, increment, data_maps, model_maps, info)``;
    ``info`` holds the ICP statistics (summed over the ranks), the
    iterations, the fallback flag, and ``counts``: a device vector
    ``[n_created, n_dropped, map_count]`` summed over the ranks followed by
    the ranks' largest block count (the fewest free arena rows)."""
    group = mesh.group
    dev = pose.device
    h = cfg.data.height
    if h % group.size:
        raise ValueError(f"image height {h} must divide over {group.size} "
                         "ranks")
    rows = h // group.size
    hw = h * cfg.data.width
    semantic = cfg.semantic.enabled
    ts_t = torch.full((), ts, dtype=torch.int32, device=dev)

    data_maps = preprocess_scan(points, labels, probs, point_valid,
                                ts_t < cfg.semantic.init_scans, cfg)
    my_data = _rows(data_maps, group.rank * rows, rows)
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    t0 = eye if cfg.icp.initialize_identity else last_inc
    result = icp_ops.gauss_newton(my_data, model_maps, t0, cfg.icp,
                                  cfg.model, semantic=semantic, group=group)
    max_creates = -(-hw // group.size)

    # the branch flags in one read: the track-loss fallback, computed from
    # the replicated increment, so every rank takes the same branch (it
    # steers the fallback's collectives), and this rank's view refresh,
    # which steers no collective
    increment, moved, need = pose_and_refresh(
        pose, result.pose, ts_t, local, cfg, mcfg, max_creates)
    jump = jump_flag(last_inc, result.pose, ts_t, cfg.icp) \
        if cfg.icp.fallback_mode else None
    jumped, refresh, new_pose = read_flags(jump, need, moved)
    if jumped:
        recovery = replace(cfg.icp,
                           max_distance=cfg.icp.fallback_max_distance,
                           max_angle=cfg.icp.fallback_max_angle)
        rec = icp_ops.gauss_newton(my_data, last_maps, t0, recovery, cfg.data,
                                   semantic=semantic, group=group)
        increment, moved, need = pose_and_refresh(
            pose, rec.pose, ts_t, local, cfg, mcfg, max_creates)
        _, refresh, new_pose = read_flags(None, need, moved)

    frame = sm.data_surfel_init(data_maps, cfg.data, mcfg)
    create_mask = (torch.arange(hw, device=dev) % group.size) == group.rank
    new_local, new_model, n_created, n_dropped = sm.fuse_and_render(
        local, frame, new_pose, ts_t, cfg.data, mcfg, conf_threshold,
        (ts + 1) - cfg.loop.delta_timestamp, semantic=semantic, group=group,
        create_mask=create_mask, max_creates=max_creates, refresh=refresh)

    mine = torch.stack([n_created, n_dropped,
                        new_local.count.to(torch.int64),
                        new_local.block_count.to(torch.int64)])
    every = group.gather(mine)                                  # [D, 4]
    counts = torch.cat([every[:, :3].sum(0), every[:, 3].amax()[None]])
    info = {"stats": result.stats, "iterations": result.iterations,
            "track_loss": bool(jumped), "counts": counts}
    return new_local, new_pose, increment, data_maps, new_model, info


def _depth_min_merge(maps: Maps, group: Group) -> Maps:
    """Merge the ranks' rendered maps by nearest depth (one gather of the
    packed maps; the lowest rank wins a tie)."""
    if group.pg is None:
        return maps
    h, w = maps.vertex.shape[:2]
    depth = torch.where(maps.vertex_valid,
                        torch.linalg.norm(maps.vertex, dim=-1), torch.inf)
    packed = torch.cat([
        depth.reshape(-1, 1), maps.vertex.reshape(-1, 3),
        maps.normal.reshape(-1, 3),
        maps.vertex_valid.reshape(-1, 1).to(torch.float32),
        maps.normal_valid.reshape(-1, 1).to(torch.float32),
        maps.sem_label.reshape(-1, 1).to(torch.float32),
        maps.sem_prob.reshape(-1, 1)], dim=-1)
    every = group.gather(packed)                            # [D, HW, 11]
    win = torch.argmin(every[..., 0], dim=0)
    g = torch.take_along_dim(every, win[None, :, None], dim=0)[0]
    return Maps(vertex=g[:, 1:4].reshape(h, w, 3),
                normal=g[:, 4:7].reshape(h, w, 3),
                vertex_valid=(g[:, 7] > 0.5).reshape(h, w),
                normal_valid=(g[:, 8] > 0.5).reshape(h, w),
                sem_label=g[:, 9].to(torch.int32).reshape(h, w),
                sem_prob=g[:, 10].reshape(h, w))


# JAX's make_sharded_compact and make_sharded_update_poses are the
# single-device sm.compact and sm.update_poses on each shard, with no
# collective: ShardedSurfelSLAM calls those directly on its shard.

def sharded_render(cfg: SumaConfig, mcfg, mesh: Mesh, local: sm.MapState,
                   pose, conf_threshold, ts_threshold) -> Maps:
    """Model render at ``pose`` (rebase): each rank refreshes a view of its
    shard around the pose and renders it; the ranks' renders merge by
    depth."""
    synced = sm.refresh_active(local, pose[:3, 3].to(torch.float32), mcfg)
    maps = sm.render_view(synced.active, pose, cfg.model, mcfg,
                          conf_threshold, ts_threshold, "new")
    return _depth_min_merge(maps, mesh.group)


def sharded_view_render(cfg: SumaConfig, mcfg, mesh: Mesh,
                        view: sm.PackedSurfels, pose, conf_threshold,
                        ts_threshold, which: str = "old") -> Maps:
    """Render the ranks' views at ``pose`` and merge them by depth (the
    old-map render of loop-closure verification)."""
    maps = sm.render_view(view, pose, cfg.model, mcfg, conf_threshold,
                          ts_threshold, which)
    return _depth_min_merge(maps, mesh.group)


class ShardedSurfelSLAM(HostLoop):
    """The host loop of one rank of the sharded pipeline: the counterpart of
    ``core.pipeline.SurfelSLAM`` with the same ``process_scan`` /
    ``process_scan_async`` / ``flush`` interface, statistics, near-capacity
    policy, host spill of this rank's shard, loop closure and rebase (the
    host loop they share is ``core.pipeline.HostLoop``). Every rank of the
    mesh drives the same scans in the same order."""

    # every rank's spill decision has to be known at once (the ranks agree
    # on it in a collective), and the pressure compaction is the JAX
    # package's sharded rule
    async_probe = False
    compact_on_free_rows = True

    def __init__(self, cfg: SumaConfig, mesh: Mesh, axis: str = "map",
                 enable_loop_closure: bool | None = None,
                 pipeline_depth: int = 4, single_process: bool = True):
        mcfg = shard_map_config(cfg, mesh.size)
        super().__init__(cfg, mcfg, mcfg.min_fresh_rows, mesh.device,
                         pipeline_depth, enable_loop_closure)
        self.mesh = mesh
        self.axis = axis
        self.group = mesh.group
        self.ndev = mesh.size
        self.mcfg = mcfg
        # JAX's single-process rule: a page-in on any rank moves map_version
        # on every rank; several processes (multihost) never move it on a
        # page-in, as in the JAX package
        self.single_process = single_process
        self.paging_moves_version = single_process
        dev = self.device
        self.local = sm.empty_map(mcfg, dev)
        self.pose = torch.eye(4, dtype=torch.float32, device=dev)
        self.last_increment = torch.eye(4, dtype=torch.float32, device=dev)
        self.last_maps = empty_maps(cfg, dev)
        self.model_maps = empty_maps(cfg, dev)

    @property
    def spilled_rows(self) -> int:
        """Rows this rank holds in host RAM."""
        return self.spill.spilled_rows if self.spill is not None else 0

    @property
    def _map(self) -> sm.MapState:
        return self.local

    def _put_map(self, new_map: sm.MapState) -> None:
        self.local = new_map

    def _agreed(self, flag: bool) -> bool:
        """True on every rank when ``flag`` holds on any rank (a max over
        the group)."""
        t = torch.tensor(int(flag), dtype=torch.int32, device=self.device)
        return bool(to_host(self.group.max(t)))

    def _step(self, points, labels, probs, point_valid, conf_threshold):
        (self.local, self.pose, self.last_increment, self.last_maps,
         self.model_maps, info) = sharded_step(
            self.cfg, self.mcfg, self.mesh, self.local, self.pose,
            self.last_increment, self.last_maps, self.model_maps,
            self._dispatched - 1, points, labels, probs, point_valid,
            conf_threshold)
        packed = pack_results(self.pose, self.last_increment, info["stats"],
                              [info["iterations"], info["track_loss"]],
                              info["counts"])
        return packed, 0

    # -- the pose-graph solve, integrated in lockstep ----------------------
    def _agree_solution(self) -> None:
        """Wait for this rank's solve and replace its result by rank 0's,
        so every rank integrates the same poses."""
        snap = self._loop._opt_future.result()
        mine = torch.as_tensor(np.stack(snap._poses), device=self.device)
        agreed = self.group.broadcast(mine, 0).cpu().numpy()
        snap._poses = [p for p in agreed]

    def _integration_ready(self) -> bool:
        """True once every rank's background solve has ended (one max over
        the group a scan while a solve is in flight)."""
        fut = self._loop._opt_future
        if fut is None:
            return False
        return not self._agreed(not fut.done())

    def _integrate(self) -> None:
        self._agree_solution()
        self._loop.integrate(self)

    def process_scan(self, points, labels=None, probs=None,
                     point_valid=None) -> dict:
        """Feed one scan synchronously (the result belongs to this scan)."""
        self._dispatch(points, labels, probs, point_valid)
        out = self._drain_one()
        if self._loop is not None and self._loop._opt_future is not None:
            self._integrate()
        return out

    def process_scan_async(self, points, labels=None, probs=None,
                           point_valid=None):
        """Pipelined driving: up to ``pipeline_depth`` scans in flight; the
        loop closer drains to synchronous operation whenever its state
        machine is active. Call :meth:`flush` after the last scan."""
        if self._loop is not None and self._integration_ready():
            self._integrate()
        self._dispatch(points, labels, probs, point_valid)
        if self._loop is not None and self._loop.sync_needed:
            return self.flush()
        if len(self._pending) > self.pipeline_depth:
            return self._drain_one()
        return None

    def flush(self):
        out = None
        while self._pending:
            out = self._drain_one()
        if self._loop is not None and self._loop._opt_future is not None:
            self._integrate()
        return out

    # -- what the loop closer calls ----------------------------------------
    def set_model_maps(self, maps) -> None:
        self.model_maps = maps

    def render_old_maps(self, view_pose):
        """Cached old-map render at ``view_pose``: each rank pages its old
        blocks into a view, renders it, and the renders merge by depth."""
        from ..core.loop_closure import OldMapRenderCache
        self._page_in(np.asarray(view_pose)[:3, 3])

        def build_view(center, thr):
            # this rank's inactive (old) blocks paged into a view
            c = torch.as_tensor(center, dtype=torch.float32,
                                device=self.device)
            return sm.refresh_active(self.local, c, self.mcfg,
                                     priority="old", ts_threshold=thr).active

        def render_view(view, pose, conf, thr):
            p = torch.as_tensor(np.asarray(pose, np.float32),
                                device=self.device)
            return sharded_view_render(self.cfg, self.mcfg, self.mesh, view,
                                       p, conf, thr, "old")

        if self._old_cache is None:
            self._old_cache = OldMapRenderCache(
                build_view, render_view,
                delta_timestamp=self.cfg.loop.delta_timestamp)
        return self._old_cache.render(view_pose, self.timestamp,
                                      self.confidence_threshold(),
                                      self.map_version)

    def rebase(self, new_poses: np.ndarray, new_current: np.ndarray) -> None:
        """Write the optimized poses into every rank's pose table (surfels
        stay in their creation frames) and re-render the model view at the
        corrected pose."""
        arr = np.tile(np.eye(4, dtype=np.float32),
                      (self.mcfg.max_poses, 1, 1))
        m = min(len(new_poses), self.mcfg.max_poses)
        arr[:m] = np.asarray(new_poses, np.float32)[:m]
        table = torch.as_tensor(arr, device=self.device)
        cur = torch.as_tensor(np.asarray(new_current, np.float32),
                              device=self.device)
        self.local = sm.update_poses(self.local, table, self.mcfg)
        self.model_maps = sharded_render(
            self.cfg, self.mcfg, self.mesh, self.local, cur,
            self.confidence_threshold(),
            self.timestamp - self.cfg.loop.delta_timestamp)
        self.pose = cur
        for i in range(min(len(new_poses), len(self.poses))):
            self.poses[i] = np.asarray(new_poses[i])
        if self.spill is not None:
            self.spill.on_rebase(arr)
        self.map_version += 1


# ---------------------------------------------------------------------------
# segmenter training: data-parallel, and column-parallel over "model"
# ---------------------------------------------------------------------------

# the JAX package's rule (``shard_train_state``): a 4-D kernel with at least
# this many output channels is split along them over the "model" axis
MODEL_MIN_CHANNELS = 128


def _out_dim(layer) -> int:
    """The output-channel dimension of a ``Conv`` weight (``[out, in, kh,
    kw]``) or a ``ConvTranspose`` weight (``[in, out, 1, 4]``)."""
    from ..models.rangenet import ConvTranspose
    return 1 if isinstance(layer, ConvTranspose) else 0


def model_axis_layers(model) -> list:
    """``(name, layer)`` of each convolution of ``model`` whose weight the
    "model" axis splits: 4-D, with at least ``MODEL_MIN_CHANNELS`` output
    channels (its flax kernel's last dimension)."""
    from ..models.rangenet import Conv, ConvTranspose
    return [(n, m) for n, m in model.named_modules()
            if isinstance(m, (Conv, ConvTranspose)) and m.weight.dim() == 4
            and m.weight.shape[_out_dim(m)] >= MODEL_MIN_CHANNELS]


def _swap_params(optimizer, swap: dict) -> None:
    """Put ``swap[old] = (new, f)``'s ``new`` in the place of ``old`` in
    ``optimizer``; its state tensors of ``old``'s shape (the AdamW moments)
    go through ``f``."""
    for pg in optimizer.param_groups:
        pg["params"] = [swap[p][0] if p in swap else p for p in pg["params"]]
    for old, (new, f) in swap.items():
        st = optimizer.state.pop(old, None)
        if st is not None:
            optimizer.state[new] = {
                k: f(v) if torch.is_tensor(v) and v.shape == old.shape else v
                for k, v in st.items()}


def shard_train_state(state, mesh: Mesh):
    """Lay a ``models.segmenter.TrainState`` out over the mesh: rank 0's
    weights and batch statistics are broadcast, and every batch norm of the
    network reduces its statistics over the ``data`` axis (the whole mesh on
    a 1-D mesh) from now on. With a ``"model"`` axis, each layer of
    :func:`model_axis_layers` keeps only this rank's slice of its output
    channels, of its weight and of the weight's AdamW moments, and computes
    column-parallel over the axis; everything else stays replicated. A width
    that the axis does not divide raises ``ValueError``."""
    from ..models.rangenet import BatchNorm
    with torch.no_grad():
        for t in [*state.model.parameters(), *state.model.buffers()]:
            t.copy_(mesh.group.broadcast(t, 0))
    for m in state.model.modules():
        if isinstance(m, BatchNorm):
            m.group = mesh.axes.get("data", mesh.group)
    group = mesh.axes.get("model")
    if group is None:
        return state
    layers = model_axis_layers(state.model)
    for name, m in layers:
        c = m.weight.shape[_out_dim(m)]
        if c % group.size:
            raise ValueError(f"{name}: {c} output channels do not divide "
                             f"over {group.size} model ranks")
    swap = {}
    for _, m in layers:
        d = _out_dim(m)
        k = m.weight.shape[d] // group.size

        def cut(t, d=d, k=k):
            return t.detach().narrow(d, group.rank * k, k).clone()

        part = torch.nn.Parameter(cut(m.weight))
        swap[m.weight] = (part, cut)
        m.weight, m.model_group = part, group
    _swap_params(state.optimizer, swap)
    return state


def unshard_train_state(state, mesh: Mesh):
    """The single-device layout of a state that :func:`shard_train_state`
    laid out: each split weight, its gradient and its AdamW moments gathered
    over the ``"model"`` axis, and no group left in the network. Every rank
    gets the whole arrays (``flax_variables_from_rangenet``,
    ``Segmenter.save`` and the checkpoints read them as they are)."""
    from ..models.rangenet import BatchNorm
    group = mesh.axes.get("model")
    swap = {}
    for m in state.model.modules():
        if isinstance(m, BatchNorm):
            m.group = None
        if getattr(m, "model_group", None) is None:
            continue
        d = _out_dim(m)

        def whole(t, d=d):
            return torch.cat(group.gather(t.detach()).unbind(0), dim=d)

        full = torch.nn.Parameter(whole(m.weight))
        if m.weight.grad is not None:
            full.grad = whole(m.weight.grad)
        swap[m.weight] = (full, whole)
        m.weight, m.model_group = full, None
    _swap_params(state.optimizer, swap)
    return state


def make_sharded_train_step(schedule, mesh: Mesh, class_weights=None):
    """The sharded step: ``models.segmenter.make_train_step`` over the
    ``data`` axis (the whole mesh on a 1-D mesh; see there), after
    :func:`shard_train_state`. On a ``("data", "model")`` mesh the ranks of
    a model row hold the same images and the same whole activations, so
    batch norm, the loss and the gradient sums run over ``data`` only."""
    from ..models.segmenter import make_train_step
    return make_train_step(schedule, class_weights,
                           group=mesh.axes.get("data", mesh.group))
