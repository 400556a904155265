"""Semantic surfel map: packed state, the block-paged active view, per-scan
fusion and the model render, and the out-of-band operations of loop closure
(read-only old-map views, renders of a view, composed old+new renders, the
pose-table rewrite) (counterpart of ``semantic_suma_tpu/core/surfel_map.py``).

Surfels live in two arrays, ``f32 [N, 16]`` (position 0:3, normal 3:6, radius
6, confidence 7, weight 8, sem_prob 9, world position 10:13, world normal
13:16) and ``i32 [N, 4]`` (timestamp, creation_ts, sem_label, valid). The
global store is an arena of fixed-size blocks; the active view holds the
blocks near the vehicle plus a fresh region that receives this cycle's
creations.

In-place updates: :func:`refresh_active_incremental` writes blocks back into
the arena in place, and :func:`fuse_and_render` writes the pose table in
place, so a ``MapState`` passed in is consumed (the counterpart of the JAX
package donating the carried state).

No function here reads the device. The JAX package's ``lax.cond`` over the
refresh flag becomes a Python branch on that flag when the caller has read
it with its other flags (:func:`refresh_needed`), and a refresh masked by
the device's flag when it has not; every other write that JAX makes under
a condition or with ``mode="drop"`` is a fixed-size masked write here
(:func:`_put_rows`), and the counts stay on the device.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch

from ..config import DataConfig, MapConfig
from ..models.labels import is_movable
from ..ops.icp import Maps
from ..ops.projection import INV_PI, pixel_rays
from ..ops.zbuffer import zbuffer_argmin, zbuffer_runs
from ..utils import lie
from ..utils.timing import Stopwatch, span

_DEG = 180.0 / math.pi

# float column layout
_POS = slice(0, 3)
_NRM = slice(3, 6)
_RADIUS = 6
_CONF = 7
_WEIGHT = 8
_SEMPROB = 9
_WPOS = slice(10, 13)
_WNRM = slice(13, 16)
NUM_F = 16
# int column layout
_TS = 0
_CTS = 1
_LABEL = 2
_VALID = 3
NUM_I = 4


class PackedSurfels(NamedTuple):
    """Two-array packed surfel storage."""

    f: torch.Tensor  # [N, 16] float32
    i: torch.Tensor  # [N, 4] int32

    @property
    def capacity(self) -> int:
        return self.f.shape[0]

    @property
    def position(self): return self.f[:, _POS]
    @property
    def normal(self): return self.f[:, _NRM]
    @property
    def radius(self): return self.f[:, _RADIUS]
    @property
    def confidence(self): return self.f[:, _CONF]
    @property
    def weight(self): return self.f[:, _WEIGHT]
    @property
    def sem_prob(self): return self.f[:, _SEMPROB]
    @property
    def wpos(self): return self.f[:, _WPOS]
    @property
    def wnormal(self): return self.f[:, _WNRM]
    @property
    def timestamp(self): return self.i[:, _TS]
    @property
    def creation_ts(self): return self.i[:, _CTS]
    @property
    def sem_label(self): return self.i[:, _LABEL]
    @property
    def valid(self): return self.i[:, _VALID] > 0


def make_packed(n: int, device, *, position=None, normal=None, radius=None,
                confidence=None, weight=None, sem_prob=None, wpos=None,
                wnormal=None, timestamp=None, creation_ts=None,
                sem_label=None, valid=None) -> PackedSurfels:
    f = torch.zeros((n, NUM_F), dtype=torch.float32, device=device)
    i = torch.zeros((n, NUM_I), dtype=torch.int32, device=device)
    for col, val in ((_POS, position), (_NRM, normal), (_RADIUS, radius),
                     (_CONF, confidence), (_WEIGHT, weight),
                     (_SEMPROB, sem_prob), (_WPOS, wpos), (_WNRM, wnormal)):
        if val is not None:
            f[:, col] = val
    for col, val in ((_TS, timestamp), (_CTS, creation_ts),
                     (_LABEL, sem_label), (_VALID, valid)):
        if val is not None:
            i[:, col] = val.to(torch.int32)
    return PackedSurfels(f=f, i=i)


class MapState(NamedTuple):
    """Block-paged surfel map."""

    data: PackedSurfels         # [CAP] global store (block arena)
    count: torch.Tensor         # int32 surfels allocated
    poses: torch.Tensor         # [MAX_POSES, 4, 4]
    active_blocks: torch.Tensor  # [K] int64 arena block per view block
    #                             (>= num_blocks = unmapped)
    active: PackedSurfels       # [K*BS] authoritative rows of those blocks
    active_count: torch.Tensor  # int32 append cursor within the view
    block_count: torch.Tensor   # int32 allocated blocks (incl. eager fresh)
    anchor: torch.Tensor        # [3] refresh center (inf => force refresh)


class FrameInputs(NamedTuple):
    maps: Maps
    radius: torch.Tensor        # [H, W]
    radius_valid: torch.Tensor  # [H, W] bool


def _geometry(cfg: MapConfig):
    """(block_size, num_blocks, view_blocks K, fresh_blocks F)."""
    bs = cfg.effective_block_size
    nb = cfg.surfel_capacity // bs
    k = cfg.active_capacity // bs
    want = max(-(-k // 3), -(-cfg.min_fresh_rows // bs))
    f = max(1, min(k - 1, want)) if k > 1 else 1
    return bs, nb, k, f


def _fresh_view(nb: int, k: int, f: int, first_fresh, device) -> torch.Tensor:
    """View block ids: K-F pads (no map blocks) then F fresh ids."""
    pads = nb + torch.arange(k - f, dtype=torch.int64, device=device)
    fresh = first_fresh + torch.arange(f, dtype=torch.int64, device=device)
    return torch.cat([pads, fresh])


def empty_map(cfg: MapConfig, device,
              reuse: MapState | None = None) -> MapState:
    """A map with nothing in it. ``reuse``: a map of the same configuration
    that nothing else uses any more, whose arena and active view are zeroed
    in place and taken instead of new ones."""
    bs, nb, k, f = _geometry(cfg)
    if reuse is None:
        data = make_packed(cfg.surfel_capacity, device)
        active = make_packed(cfg.active_capacity, device)
    else:
        data, active = reuse.data, reuse.active
        for t in (*data, *active):
            t.zero_()
    return MapState(
        data=data,
        count=torch.zeros((), dtype=torch.int32, device=device),
        poses=torch.eye(4, dtype=torch.float32, device=device).repeat(
            cfg.max_poses, 1, 1),
        active_blocks=_fresh_view(nb, k, f, 0, device),
        active=active,
        active_count=torch.full((), (k - f) * bs, dtype=torch.int32,
                                device=device),
        block_count=torch.zeros((), dtype=torch.int32, device=device),
        anchor=torch.full((3,), torch.inf, dtype=torch.float32, device=device),
    )


# ---------------------------------------------------------------------------
# active view lifecycle
# ---------------------------------------------------------------------------

def _put_rows(dst: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor,
              live: torch.Tensor) -> None:
    """``dst[ids[live]] = rows[live]`` in fixed size, in place (JAX's
    ``.at[ids].set(mode="drop")`` and its writes under ``lax.cond``): no host
    read, no boolean indexing. The live ids must be distinct. A masked-out
    entry repeats the first live entry's write, or, with none live, writes
    the row at its clamped id back unchanged, so that no two writes to one
    row carry different values."""
    n = dst.shape[0]
    # index with [1]-shaped tensors: a 0-dim tensor index is read to the host
    first = torch.argmax(live.to(torch.uint8)).reshape(1)  # first live, or 0
    tgt0 = torch.clamp(ids[first], 0, n - 1)
    pad = (1,) * (rows.dim() - 1)
    val0 = torch.where(live[first].reshape((1,) + pad), rows[first],
                       dst[tgt0])
    dst[torch.where(live, ids, tgt0)] = torch.where(
        live.reshape(live.shape + pad), rows, val0)


def _block_take(data: PackedSurfels, ids: torch.Tensor,
                bs: int) -> PackedSurfels:
    """Gather whole blocks; ids >= num_blocks give invalid (zero) rows."""
    nb = data.capacity // bs
    safe = torch.clamp_max(ids, nb - 1)
    ok = (ids < nb)[:, None, None]
    bf = data.f.reshape(nb, bs, NUM_F)[safe]
    bi = torch.where(ok, data.i.reshape(nb, bs, NUM_I)[safe], 0)
    return PackedSurfels(f=bf.reshape(-1, NUM_F), i=bi.reshape(-1, NUM_I))


def _recompute_local(rows: PackedSurfels, poses: torch.Tensor) -> PackedSurfels:
    """Re-derive creation-frame geometry from the pose table."""
    cp = poses[torch.clamp(rows.creation_ts.to(torch.int64), 0,
                           poses.shape[0] - 1)]
    r = cp[:, :3, :3]
    t = cp[:, :3, 3]
    f = rows.f.clone()
    f[:, _POS] = torch.einsum("nji,nj->ni", r, rows.wpos - t)
    f[:, _NRM] = torch.einsum("nji,nj->ni", r, rows.wnormal)
    return PackedSurfels(f=f, i=rows.i)


def sync(state: MapState, cfg: MapConfig) -> MapState:
    """Write the (authoritative) active view back into the global store, with
    its creation-frame geometry re-derived from the pose table. The store is
    copied, so the input state stays valid."""
    bs, nb, k, _ = _geometry(cfg)
    act = _recompute_local(state.active, state.poses)
    ok = state.active_blocks < nb
    new_f = state.data.f.clone().reshape(nb, bs, NUM_F)
    new_i = state.data.i.clone().reshape(nb, bs, NUM_I)
    _put_rows(new_f, state.active_blocks, act.f.reshape(k, bs, NUM_F), ok)
    _put_rows(new_i, state.active_blocks, act.i.reshape(k, bs, NUM_I), ok)
    return state._replace(
        data=PackedSurfels(f=new_f.reshape(-1, NUM_F),
                           i=new_i.reshape(-1, NUM_I)),
        active=act)


def _top_blocks(score: torch.Tensor, n: int):
    """(scores, ids) of the n best blocks, ties to the lower id (the order of
    ``lax.top_k``)."""
    s, ids = torch.sort(score, descending=True, stable=True)
    return s[:n], ids[:n]


def _score_blocks(d: PackedSurfels, center: torch.Tensor, cfg: MapConfig,
                  margin: float, priority: str, ts_threshold, allocated=None):
    """Block scores for a view around ``center``: minus the distance of the
    block's nearest valid surfel (``priority="old"`` with a ``ts_threshold``
    counts only surfels created before it), -inf beyond the view radius or
    outside ``allocated``, with a small bias toward newer ("new") or older
    ("old") blocks on near-ties."""
    bs, nb, _, _ = _geometry(cfg)
    valid = d.valid.reshape(nb, bs)
    cts = d.creation_ts.reshape(nb, bs)
    if priority == "old" and ts_threshold is not None:
        valid = valid & (cts < ts_threshold)
    dist = torch.linalg.norm(d.wpos.reshape(nb, bs, 3) - center, dim=-1)
    dmin = torch.amin(torch.where(valid, dist, torch.inf), dim=1)
    near = dmin < (cfg.active_radius + margin)
    if allocated is not None:
        near = near & allocated
    score = torch.where(near, -dmin, -torch.inf)
    bias = torch.amax(torch.where(valid, cts, 0), dim=1).to(torch.float32)
    return score + (1e-5 * bias if priority == "new" else -1e-5 * bias)


def refresh_active(state: MapState, center: torch.Tensor, cfg: MapConfig,
                   margin: float = 25.0, priority: str = "new",
                   ts_threshold=None) -> MapState:
    """Sync, then rebuild the whole view around ``center`` at block
    granularity; ``priority="old"`` with a ``ts_threshold`` pages in the
    inactive map (loop closure). Unused fresh blocks of the previous cycle
    are rolled back first."""
    bs, nb, k, f_blocks = _geometry(cfg)
    dev = center.device
    state = sync(state, cfg)
    fresh_start_row = (k - f_blocks) * bs
    fresh_used = torch.clamp_min(state.active_count - fresh_start_row, 0)
    used_blocks = (fresh_used + bs - 1) // bs
    next_alloc = torch.clamp_max(state.active_blocks[k - f_blocks]
                                 + used_blocks, nb)

    allocated = torch.arange(nb, device=dev) < next_alloc
    score = _score_blocks(state.data, center, cfg, margin, priority,
                          ts_threshold, allocated)
    top_score, top_ids = _top_blocks(score, k - f_blocks)
    pads = nb + torch.arange(k - f_blocks, device=dev)
    map_blocks = torch.where(torch.isfinite(top_score), top_ids, pads)

    fresh = next_alloc + torch.arange(f_blocks, device=dev)
    fresh = torch.where(fresh < nb, fresh,
                        nb + (k - f_blocks) + torch.arange(f_blocks,
                                                           device=dev))
    active_blocks = torch.cat([map_blocks, fresh])
    return state._replace(
        active_blocks=active_blocks,
        active=_block_take(state.data, active_blocks, bs),
        active_count=torch.full((), fresh_start_row, dtype=torch.int32,
                                device=dev),
        block_count=torch.clamp_max(next_alloc + f_blocks, nb).to(torch.int32),
        anchor=center.to(torch.float32))


def build_view(state: MapState, center: torch.Tensor, cfg: MapConfig,
               n_blocks: int, ts_threshold=None, margin: float = 25.0,
               priority: str = "old") -> PackedSurfels:
    """READ-ONLY [n_blocks*bs]-row view around ``center``: the block scoring
    of :func:`refresh_active` without touching the active view, the fresh
    allocation or the arena bookkeeping. The rows are a copy: later scans
    and pose rewrites do not reach them. Used by loop-closure verification
    (a smaller view halves the cost of each old-map render)."""
    bs, nb, _, _ = _geometry(cfg)
    state = sync(state, cfg)  # fold the (authoritative) active view in
    score = _score_blocks(state.data, center, cfg, margin, priority,
                          ts_threshold)
    top_score, top_ids = _top_blocks(score, n_blocks)
    ids = torch.where(torch.isfinite(top_score), top_ids, nb)
    view = _block_take(state.data, ids, bs)
    if priority == "old" and ts_threshold is not None:
        # blocks may mix old and new surfels; mask the new ones so the
        # caller's render ("old" selection) sees a pure inactive view
        keep = view.creation_ts < ts_threshold
        i = view.i.clone()
        i[:, _VALID] = (view.valid & keep).to(torch.int32)
        view = PackedSurfels(f=view.f, i=i)
    return view


def refresh_active_incremental(state: MapState, center: torch.Tensor,
                               cfg: MapConfig, margin: float = 25.0,
                               when: torch.Tensor | None = None) -> MapState:
    """View refresh that moves only changed blocks: write back this cycle's
    used fresh blocks, score blocks (view-resident blocks scored from the
    authoritative view rows), swap evicted slots for incoming blocks, and zero
    the new fresh region. Unchanged map blocks keep stale creation-frame
    columns in the view; they are recomputed at writeback.

    JAX loops over the used fresh blocks and the changed slots; here every
    fresh slot and every map slot of the view is written in fixed size,
    masked by ``slot < used_blocks`` and by ``i < n_changed``, with no host
    read. ``when`` (a device bool) masks the whole refresh as well: where it
    is false the state comes back as it was, so that a caller without a
    host-side decision refreshes under the device's one. The arena
    (``state.data``) is updated IN PLACE."""
    bs, nb, k, f_blocks = _geometry(cfg)
    km = k - f_blocks
    dev = center.device
    act = state.active
    data = state.data
    data_f = data.f.reshape(nb, bs, NUM_F)
    data_i = data.i.reshape(nb, bs, NUM_I)

    fresh_start_row = km * bs
    fresh_used = torch.clamp_min(state.active_count - fresh_start_row, 0)
    used_blocks = (fresh_used + bs - 1) // bs
    next_alloc = torch.clamp_max(state.active_blocks[km] + used_blocks, nb)

    # 1. write back the used fresh blocks
    bids = state.active_blocks[km:]
    used = (torch.arange(f_blocks, device=dev) < used_blocks) & (bids < nb)
    if when is not None:
        used = used & when
    rows = _recompute_local(PackedSurfels(act.f[km * bs:], act.i[km * bs:]),
                            state.poses)
    _put_rows(data_f, bids, rows.f.reshape(f_blocks, bs, NUM_F), used)
    _put_rows(data_i, bids, rows.i.reshape(f_blocks, bs, NUM_I), used)

    # 2. block scoring (global, overridden by the view's own rows)
    gvalid = data.valid.reshape(nb, bs)
    dmin = torch.amin(torch.where(
        gvalid, torch.linalg.norm(data_f[..., _WPOS] - center, dim=-1),
        torch.inf), dim=1)
    cts = torch.amax(torch.where(gvalid, data.creation_ts.reshape(nb, bs), 0),
                     dim=1)
    v_valid = act.valid.reshape(k, bs)[:km]
    v_dmin = torch.amin(torch.where(
        v_valid,
        torch.linalg.norm(act.wpos.reshape(k, bs, 3)[:km] - center, dim=-1),
        torch.inf), dim=1)
    v_cts = torch.amax(torch.where(v_valid,
                                   act.creation_ts.reshape(k, bs)[:km], 0),
                       dim=1)
    curm = state.active_blocks[:km]
    in_arena = curm < nb
    _put_rows(dmin, curm, v_dmin, in_arena)
    _put_rows(cts, curm, v_cts, in_arena)

    allocated = torch.arange(nb, device=dev) < next_alloc
    near = dmin < (cfg.active_radius + margin)
    score = torch.where(allocated & near, -dmin, -torch.inf)
    score = score + 1e-5 * cts.to(torch.float32)
    top_score, top_ids = _top_blocks(score, km)
    pads = nb + torch.arange(km, device=dev)
    target = torch.where(torch.isfinite(top_score), top_ids, pads)

    # 3. pair evicted slots with incoming blocks (both in stable order)
    true = torch.ones((km,), dtype=torch.bool, device=dev)
    in_target = torch.zeros((nb,), dtype=torch.bool, device=dev)
    _put_rows(in_target, target, true, target < nb)
    stay = in_arena & in_target[torch.clamp_max(curm, nb - 1)]
    in_view = torch.zeros((nb,), dtype=torch.bool, device=dev)
    _put_rows(in_view, curm, true, in_arena)
    t_incoming = ~((target < nb) & in_view[torch.clamp_max(target, nb - 1)])
    evict_slots = torch.sort(stay.to(torch.int32), stable=True).indices
    inc_perm = torch.sort((~t_incoming).to(torch.int32), stable=True).indices
    incoming_ids = target[inc_perm]
    changed = torch.arange(km, device=dev) < km - stay.sum()
    if when is not None:
        changed = changed & when

    # the first n_changed evicted slots are written back and take the
    # incoming blocks; evicted and incoming blocks are disjoint (incoming
    # blocks are not in the view), so the writebacks and the reads do not
    # interact. ``evict_slots`` is a permutation of the map slots: the view's
    # writes go to distinct slots, the unchanged ones with their own rows.
    ab = state.active_blocks.clone()
    act_f = act.f.clone().reshape(k, bs, NUM_F)
    act_i = act.i.clone().reshape(k, bs, NUM_I)
    old = ab[evict_slots]
    rows = _recompute_local(PackedSurfels(
        act_f[evict_slots].reshape(-1, NUM_F),
        act_i[evict_slots].reshape(-1, NUM_I)), state.poses)
    wb = changed & (old < nb)
    _put_rows(data_f, old, rows.f.reshape(km, bs, NUM_F), wb)
    _put_rows(data_i, old, rows.i.reshape(km, bs, NUM_I), wb)
    gok = (changed & (incoming_ids < nb))[:, None, None]
    safe = torch.clamp_max(incoming_ids, nb - 1)
    keep = ~changed[:, None, None]
    act_f[evict_slots] = torch.where(
        keep, act_f[evict_slots], torch.where(gok, data_f[safe], 0.0))
    act_i[evict_slots] = torch.where(
        keep, act_i[evict_slots], torch.where(gok, data_i[safe], 0))
    ab[evict_slots] = torch.where(changed, incoming_ids, old)

    # 4. new fresh region: known-empty arena blocks, so just zero
    fresh = next_alloc + torch.arange(f_blocks, device=dev)
    fresh = torch.where(fresh < nb, fresh,
                        nb + km + torch.arange(f_blocks, device=dev))
    active_count = torch.full((), fresh_start_row, dtype=torch.int32,
                              device=dev)
    block_count = torch.clamp_max(next_alloc + f_blocks, nb).to(torch.int32)
    anchor = center.to(torch.float32)
    if when is None:
        ab[km:] = fresh
        act_f[km:] = 0.0
        act_i[km:] = 0
    else:
        ab[km:] = torch.where(when, fresh, ab[km:])
        act_f[km:] = torch.where(when, 0.0, act_f[km:])
        act_i[km:] = torch.where(when, 0, act_i[km:])
        active_count = torch.where(when, active_count, state.active_count)
        block_count = torch.where(when, block_count, state.block_count)
        anchor = torch.where(when, anchor, state.anchor)

    return state._replace(
        active=PackedSurfels(f=act_f.reshape(-1, NUM_F),
                             i=act_i.reshape(-1, NUM_I)),
        active_blocks=ab, active_count=active_count, block_count=block_count,
        anchor=anchor)


def refresh_needed(state: MapState, center: torch.Tensor, cfg: MapConfig,
                   pending_creates: int, margin: float = 25.0,
                   refresh_distance: float | None = None) -> torch.Tensor:
    """The view-refresh test of :func:`maybe_refresh`, as a device bool:
    the vehicle left the refresh radius (``refresh_distance``, by default
    half the margin), the fresh region cannot hold this scan's potential
    creations (while the arena can still allocate), or the anchor is
    unset."""
    bs, nb, k, _ = _geometry(cfg)
    rd = refresh_distance if refresh_distance is not None else margin * 0.5
    moved = torch.linalg.norm(center - state.anchor) > rd
    full = (state.active_count + pending_creates > k * bs) \
        & (state.block_count < nb)
    return moved | full | torch.any(~torch.isfinite(state.anchor))


def maybe_refresh(state: MapState, center: torch.Tensor, cfg: MapConfig,
                  pending_creates: int, margin: float = 25.0,
                  refresh_distance: float | None = None,
                  need: bool | None = None) -> MapState:
    """Refresh the view iff :func:`refresh_needed` (JAX's ``lax.cond``).
    ``need`` is that test's value when the caller has read it already, with
    its other branch flags, and skips the refresh's work where it is false.
    Without it nothing is read: the refresh runs masked by the device's
    test."""
    if need is None:
        return refresh_active_incremental(
            state, center, cfg, margin,
            when=refresh_needed(state, center, cfg, pending_creates, margin,
                                refresh_distance))
    if need:
        return refresh_active_incremental(state, center, cfg, margin)
    return state


# ---------------------------------------------------------------------------
# per-pixel data-surfel initialization
# ---------------------------------------------------------------------------

def data_surfel_init(maps: Maps, data_cfg: DataConfig,
                     map_cfg: MapConfig) -> FrameInputs:
    v = maps.vertex
    n = maps.normal
    d = torch.linalg.norm(v, dim=-1)
    view = -v / torch.clamp_min(d, 1e-12)[..., None]
    cos_ang = torch.sum(n * view, dim=-1)
    angle_thresh = math.cos(math.radians(map_cfg.max_angle))
    valid = maps.vertex_valid & maps.normal_valid & (cos_ang > angle_thresh)
    radius = 1.41 * d * data_cfg.pixel_size / torch.clamp(cos_ang, 0.5, 1.0)
    radius = torch.clamp(radius, map_cfg.min_radius, map_cfg.max_radius)
    return FrameInputs(maps=maps, radius=torch.where(valid, radius, 0.0),
                       radius_valid=valid)


# ---------------------------------------------------------------------------
# projection helpers
# ---------------------------------------------------------------------------

def _project_px(pts: torch.Tensor, cfg: DataConfig):
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    depth = torch.sqrt(x * x + y * y + z * z)
    yaw = torch.atan2(y, x)
    pitch = -torch.asin(torch.clamp(z / torch.clamp_min(depth, 1e-12),
                                    -1.0, 1.0))
    xf = 0.5 * (-yaw * INV_PI + 1.0) * cfg.width
    yf = (1.0 - (pitch * _DEG + cfg.fov_up) / cfg.fov) * cfg.height
    px = torch.clamp(torch.floor(xf), 0, cfg.width - 1).to(torch.int64)
    py_f = torch.floor(yf)
    py = torch.clamp(py_f, 0, cfg.height - 1).to(torch.int64)
    inside = ((depth >= cfg.min_depth) & (depth <= cfg.max_depth)
              & (py_f >= 0) & (py_f < cfg.height))
    return px, py, depth, inside


class _Projected(NamedTuple):
    p_c: torch.Tensor   # position in the camera frame
    n_c: torch.Tensor   # normal in the camera frame
    depth: torch.Tensor
    px: torch.Tensor
    py: torch.Tensor
    inside: torch.Tensor
    cosv: torch.Tensor  # cosine of the view angle (normal vs ray to sensor)


def _project_surfels(data: PackedSurfels, pose_inv: torch.Tensor,
                     cfg: DataConfig) -> _Projected:
    r = pose_inv[:3, :3]
    t = pose_inv[:3, 3]
    p_c = data.wpos @ r.T + t
    n_c = data.wnormal @ r.T
    depth = torch.linalg.norm(p_c, dim=-1)
    cosv = torch.sum(n_c * (-p_c), dim=-1) / torch.clamp_min(depth, 1e-12)
    px, py, depth, inside = _project_px(p_c, cfg)
    return _Projected(p_c, n_c, depth, px, py, inside, cosv)


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------

def _disk_resolve(img: torch.Tensor, hasg: torch.Tensor, cfg: DataConfig,
                  resolve_radius: int = 1) -> Maps:
    """Dense winner image [H, W, 9] (p_c 0:3, n_c 3:6, radius 6, label 7,
    prob 8) -> model maps: each pixel keeps the nearest candidate of its
    (2R+1)^2 neighbourhood whose tangent disk its ray hits. Columns wrap;
    rows do not."""
    h, w = cfg.height, cfg.width
    dev = img.device
    rr = resolve_radius
    rays = pixel_rays(cfg, device=dev)
    best_t = torch.full((h, w), torch.inf, dtype=torch.float32, device=dev)
    best = torch.zeros((h, w, 9), dtype=torch.float32, device=dev)
    best_ok = torch.zeros((h, w), dtype=torch.bool, device=dev)
    for dy in range(-rr, rr + 1):
        rolled = torch.roll(img, -dy, dims=0)
        rolled_has = torch.roll(hasg, -dy, dims=0)
        if dy > 0:
            rolled_has[h - dy:] = False
        elif dy < 0:
            rolled_has[:-dy] = False
        for dx in range(-rr, rr + 1):
            nb = torch.roll(rolled, -dx, dims=1)
            nb_has = torch.roll(rolled_has, -dx, dims=1)
            p = nb[..., 0:3]
            n = nb[..., 3:6]
            r = nb[..., 6]
            denom = torch.sum(n * rays, dim=-1)
            t = torch.sum(n * p, dim=-1) / torch.where(
                torch.abs(denom) < 1e-9, 1e-9, denom)
            hit = torch.linalg.norm(rays * t[..., None] - p, dim=-1) <= r
            ok = nb_has & hit & (t > cfg.min_depth) & (t < cfg.max_depth)
            closer = ok & (t < best_t)
            best_t = torch.where(closer, t, best_t)
            best = torch.where(closer[..., None], nb, best)
            best_ok = best_ok | closer
    return Maps(vertex=best[..., 0:3], normal=best[..., 3:6],
                vertex_valid=best_ok, normal_valid=best_ok,
                sem_label=best[..., 7].to(torch.int32), sem_prob=best[..., 8])


class RenderEntries(NamedTuple):
    data: PackedSurfels
    proj: _Projected
    sel: torch.Tensor


def _selection(data: PackedSurfels, proj: _Projected, map_cfg: MapConfig,
               conf_threshold, ts_threshold, which: str) -> torch.Tensor:
    sel = data.valid & (proj.cosv > 0.01) & proj.inside
    if map_cfg.use_stability:
        sel = sel & (data.confidence > conf_threshold)
    if which == "old":
        sel = sel & (data.creation_ts < ts_threshold)
    elif which == "new":
        sel = sel & ((data.creation_ts >= ts_threshold)
                     | (data.timestamp >= ts_threshold))
    return sel


def _resolve_maps(entries_list: Sequence[RenderEntries], cfg: DataConfig,
                  resolve_radius: int = 1) -> Maps:
    """Candidate streams -> model maps: the nearest candidate per pixel by
    one z-buffer pass over every stream (surfel centers only), its
    attributes gathered into one dense [H, W, 9] image, then the tangent-
    disk resolve."""
    h, w = cfg.height, cfg.width
    hw = h * w
    ids, deps, attrs = [], [], []
    for e in entries_list:
        ids.append(torch.where(e.sel, e.proj.py * w + e.proj.px, -1))
        deps.append(torch.where(e.sel, e.proj.depth, torch.inf))
        attrs.append(torch.cat([
            e.proj.p_c, e.proj.n_c, e.data.radius[:, None],
            e.data.sem_label[:, None].to(torch.float32),
            e.data.sem_prob[:, None]], dim=-1))
    winner, _ = zbuffer_argmin(torch.cat(ids), torch.cat(deps), hw,
                               depth_bound=max(100.0, cfg.max_depth))
    has = winner >= 0
    img = torch.where(has[:, None], torch.cat(attrs)[winner.clamp_min(0)], 0.0)
    return _disk_resolve(img.reshape(h, w, 9), has.reshape(h, w), cfg,
                         resolve_radius)


def render_view(data: PackedSurfels, pose: torch.Tensor, cfg: DataConfig,
                map_cfg: MapConfig, conf_threshold, ts_threshold,
                which: str = "new") -> Maps:
    pose_inv = lie.se3_inverse(pose.to(torch.float32))
    proj = _project_surfels(data, pose_inv, cfg)
    sel = _selection(data, proj, map_cfg, conf_threshold, ts_threshold, which)
    return _resolve_maps([RenderEntries(data, proj, sel)], cfg,
                         map_cfg.splat_resolve_radius)


def render_maps(state: MapState, pose: torch.Tensor, cfg: DataConfig,
                map_cfg: MapConfig, conf_threshold, ts_threshold,
                render_old: bool = False) -> Maps:
    """Out-of-band render (rebase, tests): syncs the view, then renders from
    a fresh active subset around the pose."""
    synced = refresh_active(state, pose[:3, 3].to(torch.float32), map_cfg,
                            priority="old" if render_old else "new",
                            ts_threshold=ts_threshold if render_old else None)
    return render_view(synced.active, pose, cfg, map_cfg, conf_threshold,
                       ts_threshold, "old" if render_old else "new")


def render_composed(state: MapState, pose_old: torch.Tensor,
                    pose_new: torch.Tensor, cfg: DataConfig,
                    map_cfg: MapConfig, conf_threshold, ts_threshold) -> Maps:
    """Old surfels from pose_old + new surfels from pose_new in one z-buffer.
    Uses two view refreshes so that under view overflow both the old and the
    new map parts are represented."""
    inv_old = lie.se3_inverse(pose_old.to(torch.float32))
    inv_new = lie.se3_inverse(pose_new.to(torch.float32))
    data_o = refresh_active(state, pose_old[:3, 3].to(torch.float32), map_cfg,
                            priority="old", ts_threshold=ts_threshold).active
    data_n = refresh_active(state, pose_new[:3, 3].to(torch.float32), map_cfg,
                            priority="new").active
    proj_o = _project_surfels(data_o, inv_old, cfg)
    proj_n = _project_surfels(data_n, inv_new, cfg)
    sel_o = _selection(data_o, proj_o, map_cfg, conf_threshold, ts_threshold,
                       "old")
    sel_n = _selection(data_n, proj_n, map_cfg, conf_threshold, ts_threshold,
                       "new")
    return _resolve_maps([RenderEntries(data_o, proj_o, sel_o),
                          RenderEntries(data_n, proj_n, sel_n)], cfg,
                         map_cfg.splat_resolve_radius)


def compose_views(old: Maps, new: Maps, max_distance: float) -> Maps:
    """Image-space merge of an old-map render into a new-map render: a pixel
    takes the old map where the new one has nothing complete and the two
    agree within ``max_distance`` (or the new one has no vertex at all)."""
    new_ok = new.vertex_valid & new.normal_valid
    old_ok = old.vertex_valid & old.normal_valid
    dist = torch.linalg.norm(new.vertex - old.vertex, dim=-1)
    take_old = ~new_ok & old_ok & (~new.vertex_valid | (dist < max_distance))
    return Maps(
        vertex=torch.where(take_old[..., None], old.vertex, new.vertex),
        normal=torch.where(take_old[..., None], old.normal, new.normal),
        vertex_valid=torch.where(take_old, old.vertex_valid,
                                 new.vertex_valid),
        normal_valid=torch.where(take_old, old.normal_valid,
                                 new.normal_valid),
        sem_label=torch.where(take_old, old.sem_label, new.sem_label),
        sem_prob=torch.where(take_old, old.sem_prob, new.sem_prob))


def _index_winner(data: PackedSurfels, pose_inv: torch.Tensor,
                  cfg: DataConfig) -> torch.Tensor:
    """Nearest visible surfel row per pixel, -1 = none."""
    proj = _project_surfels(data, pose_inv, cfg)
    ok = data.valid & (proj.cosv > 0.01) & proj.inside
    ids = torch.where(ok, proj.py * cfg.width + proj.px, -1)
    winner, _ = zbuffer_argmin(ids, proj.depth, cfg.height * cfg.width,
                               depth_bound=max(100.0, cfg.max_depth))
    return winner


def render_index_map(state: MapState, pose_inv: torch.Tensor,
                     cfg: DataConfig, map_cfg: MapConfig) -> torch.Tensor:
    """Full-store index map [H, W] (global rows)."""
    synced = sync(state, map_cfg)
    return _index_winner(synced.data, pose_inv, cfg).reshape(
        cfg.height, cfg.width)


# ---------------------------------------------------------------------------
# map update
# ---------------------------------------------------------------------------

def _slerp(v0, v1, w):
    """Normalized spherical interpolation (w weights v0)."""
    d = torch.clamp(torch.sum(v0 * v1, dim=-1), -1.0, 1.0)
    omega = torch.arccos(d)
    so = torch.sin(omega)
    safe = torch.abs(so) > 1e-5
    so_safe = torch.where(safe, so, 1.0)
    w0 = torch.where(safe, torch.sin(w * omega) / so_safe, w)
    w1 = torch.where(safe, torch.sin((1.0 - w) * omega) / so_safe, 1.0 - w)
    out = w0[..., None] * v0 + w1[..., None] * v1
    return out / torch.clamp_min(torch.linalg.norm(out, dim=-1, keepdim=True),
                                 1e-12)


def _pack_frame_image(frame: FrameInputs) -> torch.Tensor:
    """[HW, 10] frame image: vertex 0:3, normal 3:6, valid 6, label 7,
    prob 8, radius 9."""
    m = frame.maps
    return torch.cat([
        m.vertex.reshape(-1, 3), m.normal.reshape(-1, 3),
        (m.vertex_valid & m.normal_valid).reshape(-1, 1).to(torch.float32),
        m.sem_label.reshape(-1, 1).to(torch.float32),
        m.sem_prob.reshape(-1, 1), frame.radius.reshape(-1, 1)], dim=-1)


class _UpdateStage(NamedTuple):
    """The part of the per-surfel update that does not depend on the
    index-map winner."""

    proj: _Projected
    pid: torch.Tensor
    observed: torch.Tensor
    compatible: torch.Tensor
    penalty: torch.Tensor
    log_odds_up: torch.Tensor
    integrate: torch.Tensor
    new_conf_nc: torch.Tensor   # updated confidence if NOT index winner
    avg_pos_w: torch.Tensor
    avg_nrm_w: torch.Tensor
    avg_prob: torch.Tensor
    upd_radius: torch.Tensor
    new_weight: torch.Tensor
    new_ts: torch.Tensor


def _update_stage_a(data: PackedSurfels, frame_img: torch.Tensor,
                    pose: torch.Tensor, proj: _Projected, ts: torch.Tensor,
                    data_cfg: DataConfig, map_cfg: MapConfig,
                    semantic: bool) -> _UpdateStage:
    """Winner-independent part of the per-surfel update."""
    act = data.capacity
    dev = data.f.device
    pid = proj.py * data_cfg.width + proj.px

    g = frame_img[pid]
    v_meas, n_meas = g[:, 0:3], g[:, 3:6]
    m_valid = g[:, 6] > 0.5
    d_label = g[:, 7].to(torch.int32)
    d_prob = g[:, 8]
    new_radius_meas = g[:, 9]

    observed = data.valid & (proj.cosv > 0.0) & proj.inside & m_valid

    v_g = v_meas @ pose[:3, :3].T + pose[:3, 3]
    n_g = n_meas @ pose[:3, :3].T
    n_g = n_g / torch.clamp_min(torch.linalg.norm(n_g, dim=-1, keepdim=True),
                                1e-12)

    wpos = data.wpos
    wnrm = data.wnormal
    dist = torch.abs(torch.sum(wnrm * (v_g - wpos), dim=-1))
    angle = torch.linalg.norm(torch.linalg.cross(n_g, wnrm, dim=-1), dim=-1)
    angle_thresh = math.sin(math.radians(map_cfg.map_max_angle))
    compatible = observed & (dist < map_cfg.max_distance) \
        & (angle < angle_thresh)

    mismatch = d_label != data.sem_label
    penalty = torch.where(observed & mismatch & is_movable(data.sem_label)
                          & semantic, 1.0, 0.0)

    p_up = torch.full((act,), map_cfg.p_stable, dtype=torch.float32,
                      device=dev)
    if map_cfg.confidence_mode in (1, 3):
        p_up = p_up * torch.exp(-angle * angle / (map_cfg.sigma_angle ** 2))
    if map_cfg.confidence_mode in (2, 3):
        p_up = p_up * torch.exp(-dist * dist / (map_cfg.sigma_distance ** 2))
    p_up = torch.clamp(p_up, map_cfg.p_unstable, 1.0)
    log_odds_up = torch.log(p_up / (1.0 - p_up))

    update_conf_nc = torch.where(compatible, log_odds_up, map_cfg.log_prior) \
        - penalty
    if map_cfg.use_stability:
        new_conf_nc = torch.clamp_max(
            data.confidence + update_conf_nc - map_cfg.log_prior,
            map_cfg.stability_upper_bound)
    else:
        new_conf_nc = data.confidence

    young = (ts - data.creation_ts) < 100
    integrate = compatible & (((new_radius_meas < data.radius) & young)
                              | map_cfg.update_always)

    if map_cfg.weighting_scheme == 0:
        w1 = torch.full((act,), 0.9, dtype=torch.float32, device=dev)
        w2 = torch.full((act,), 0.1, dtype=torch.float32, device=dev)
        new_weight = data.weight
    else:
        w1 = data.weight
        view_dir = -v_meas / torch.clamp_min(
            torch.linalg.norm(v_meas, dim=-1, keepdim=True), 1e-12)
        w2 = (torch.sum(n_meas * view_dir, dim=-1)
              if map_cfg.weighting_scheme == 2 else torch.ones_like(w1))
        new_weight = torch.where(
            integrate, torch.clamp_max(w1 + w2, map_cfg.max_weight),
            data.weight)
        s = w1 + w2
        w1, w2 = w1 / s, w2 / s

    avg_pos_w = w1[:, None] * wpos + w2[:, None] * v_g
    if map_cfg.averaging_scheme == 1:
        signed = torch.sum(wnrm * (v_g - wpos), dim=-1)
        avg_pos_w = wpos + (w2 * signed)[:, None] * wnrm
    avg_nrm_w = _slerp(wnrm, n_g, w1)

    avg_prob = torch.where(mismatch,
                           w1 * data.sem_prob + w2 * (1.0 - d_prob),
                           w1 * data.sem_prob + w2 * d_prob)
    upd_radius = torch.clamp_min(torch.minimum(new_radius_meas, data.radius),
                                 map_cfg.min_radius)
    new_ts = torch.where(compatible, ts, data.timestamp)

    return _UpdateStage(proj=proj, pid=pid, observed=observed,
                        compatible=compatible, penalty=penalty,
                        log_odds_up=log_odds_up, integrate=integrate,
                        new_conf_nc=new_conf_nc, avg_pos_w=avg_pos_w,
                        avg_nrm_w=avg_nrm_w, avg_prob=avg_prob,
                        upd_radius=upd_radius, new_weight=new_weight,
                        new_ts=new_ts)


def _update_finish(data: PackedSurfels, a: _UpdateStage,
                   closest: torch.Tensor, ts: torch.Tensor,
                   map_cfg: MapConfig, confidence_threshold) -> PackedSurfels:
    """Apply stage A plus the index-winner confidence decrease and the cull.
    Only the world-frame geometry is maintained per scan."""
    decreased = a.observed & ~a.compatible & closest
    if map_cfg.use_stability:
        new_conf = torch.where(
            decreased,
            torch.clamp_max(data.confidence + map_cfg.log_unstable - a.penalty
                            - map_cfg.log_prior,
                            map_cfg.stability_upper_bound),
            a.new_conf_nc)
    else:
        new_conf = a.new_conf_nc

    f = data.f.clone()
    intg = a.integrate[:, None]
    f[:, _WPOS] = torch.where(intg, a.avg_pos_w, data.wpos)
    f[:, _WNRM] = torch.where(intg, a.avg_nrm_w, data.wnormal)
    f[:, _RADIUS] = torch.where(a.compatible, a.upd_radius, data.radius)
    f[:, _CONF] = new_conf
    f[:, _SEMPROB] = torch.where(a.integrate, a.avg_prob, data.sem_prob)
    if map_cfg.weighting_scheme:
        f[:, _WEIGHT] = a.new_weight

    i = data.i.clone()
    i[:, _TS] = a.new_ts.to(torch.int32)
    alive = data.valid
    if map_cfg.use_stability:
        unstable_old = (data.confidence < confidence_threshold) & (
            (ts - data.timestamp) >= map_cfg.unstable_age)
        alive = alive & (~unstable_old | a.compatible)
        alive = alive & (new_conf >= map_cfg.log_unstable)
    i[:, _VALID] = alive.to(torch.int32)
    return PackedSurfels(f=f, i=i)


def _make_new_surfels(frame: FrameInputs, pose: torch.Tensor,
                      ts: torch.Tensor, integrated: torch.Tensor,
                      map_cfg: MapConfig, semantic: bool):
    """Per-pixel creation records (valid where a pixel creates a surfel)."""
    maps = frame.maps
    hw = integrated.shape[0]
    dev = integrated.device
    vflat = maps.vertex.reshape(-1, 3)
    nflat = maps.normal.reshape(-1, 3)
    create = (maps.vertex_valid & maps.normal_valid).reshape(-1) \
        & frame.radius_valid.reshape(-1) & ~integrated
    labels = maps.sem_label.reshape(-1)
    conf = torch.where(is_movable(labels) & semantic,
                       map_cfg.log_prior - 0.5, map_cfg.log_prior)
    ts_arr = ts.to(torch.int32).expand(hw)
    data = make_packed(
        hw, dev, position=vflat, normal=nflat,
        radius=frame.radius.reshape(-1), confidence=conf,
        weight=torch.ones((hw,), dtype=torch.float32, device=dev),
        sem_prob=maps.sem_prob.reshape(-1),
        wpos=vflat @ pose[:3, :3].T + pose[:3, 3],
        wnormal=nflat @ pose[:3, :3].T,
        timestamp=ts_arr, creation_ts=ts_arr, sem_label=labels, valid=create)
    return data, create


def creation_region_rows(hw: int, max_creates: int | None = None) -> int:
    """Rows the fresh region must hold for one scan's creations, at most
    ``max_creates`` of them (the append writes whole chunks, so the
    chunk-rounded worst case)."""
    n_chunks = 4 if hw % 4 == 0 else 1
    ch = hw // n_chunks
    mc = hw if max_creates is None else max_creates
    return -(-mc // ch) * ch


def fuse_and_render(state: MapState, frame: FrameInputs, pose: torch.Tensor,
                    timestamp, data_cfg: DataConfig, map_cfg: MapConfig,
                    confidence_threshold, render_ts_threshold,
                    semantic: bool = True, group=None,
                    create_mask: torch.Tensor | None = None,
                    max_creates: int | None = None,
                    refresh: bool | None = None,
                    stopwatch: Stopwatch | None = None):
    """Per-scan map update + post-update model render on the active view,
    with a conditional view refresh. Returns (new_state, model_maps,
    n_created, n_dropped), the counts as device tensors: nothing here reads
    the device. ``refresh`` is :func:`refresh_needed` at ``pose`` when the
    caller has read it (see :func:`maybe_refresh`). ``state`` is consumed:
    its arena and pose table are updated in place.

    Sharded (``group``, a ``parallel.distributed.Group``): ``state`` is this
    rank's shard and ``create_mask`` gives each pixel's creation to one rank
    (at most ``max_creates`` a rank). The ranks agree through five
    collectives, entered by every rank on every call: a gather of the winner
    depths with an argmin over the ranks for the global index-map winner
    (the lowest rank on a tie), a sum-OR of the integrated flags, a
    depth-min merge of the render candidates (two gathers) and a sum of the
    ranks' room for their creations.

    With a ``stopwatch`` its parts are the spans ``fuse/refresh`` (the view
    refresh), ``fuse/update`` (projection, update and selection over one
    z-buffer pass), ``fuse/create`` (the creations' compaction and append)
    and ``fuse/render`` (the model render from the shared z-buffer)."""
    dev = pose.device
    pose = pose.to(torch.float32)
    pose_inv = lie.se3_inverse(pose)
    ts = (timestamp.to(torch.int32) if isinstance(timestamp, torch.Tensor)
          else torch.full((), int(timestamp), dtype=torch.int32, device=dev))
    hw = data_cfg.height * data_cfg.width
    bs, nb, k, f_blocks = _geometry(map_cfg)
    view_rows = k * bs
    mc_eff = creation_region_rows(hw, max_creates)
    if f_blocks * bs < mc_eff:
        raise ValueError(
            f"fresh region ({f_blocks}x{bs} rows) must hold one scan's worst-"
            f"case creations ({mc_eff}); increase MapConfig.active_capacity")

    with span(stopwatch, "fuse/refresh"):
        state = maybe_refresh(state, pose[:3, 3], map_cfg,
                              pending_creates=mc_eff, need=refresh)

    # ---- per-surfel update and render selection over one z-buffer pass ----
    with span(stopwatch, "fuse/update"):
        act = state.active
        proj = _project_surfels(act, pose_inv, data_cfg)
        frame_img = _pack_frame_image(frame)
        a = _update_stage_a(act, frame_img, pose, proj, ts, data_cfg, map_cfg,
                            semantic)

        idx_sel = act.valid & (proj.cosv > 0.01) & proj.inside
        rsel = idx_sel
        if map_cfg.use_stability:
            unstable_old = (act.confidence < confidence_threshold) & (
                (ts - act.timestamp) >= map_cfg.unstable_age)
            alive_nc = (~unstable_old | a.compatible) \
                & (a.new_conf_nc >= map_cfg.log_unstable)
            rsel = rsel & alive_nc & (a.new_conf_nc > confidence_threshold)
        rsel = rsel & ((act.creation_ts >= render_ts_threshold)
                       | (a.new_ts >= render_ts_threshold))

        # one z-buffer pass answers the index-map winner, the render winner
        # (rsel) and "a compatible surfel lands on this pixel" (existence only)
        ids = torch.where(idx_sel, a.pid, -1)
        winner_all, (winner_render, winner_compat), (wdepth_render, _) = \
            zbuffer_runs(ids, proj.depth, (rsel, a.compatible), hw,
                         depth_bound=max(100.0, data_cfg.max_depth),
                         flag_payloads=(True, False))
        integrated = winner_compat >= 0

        pid_safe = torch.clamp_max(a.pid, hw - 1)
        closest = winner_all[pid_safe] == torch.arange(act.capacity,
                                                       device=dev)
        if group is not None:
            # the local winner counts only where this rank also wins the
            # depth argmin over the ranks
            wd = torch.where(winner_all >= 0,
                             proj.depth[winner_all.clamp_min(0)], torch.inf)
            i_win = (torch.argmin(group.gather(wd), dim=0) == group.rank) \
                & (winner_all >= 0)
            closest = closest & i_win[pid_safe]
            integrated = group.sum(integrated.to(torch.int32)) > 0
        upd = _update_finish(act, a, closest, ts, map_cfg,
                             confidence_threshold)

    with span(stopwatch, "fuse/create"):
        new_data, create = _make_new_surfels(frame, pose, ts, integrated,
                                             map_cfg, semantic)
        create_all = create
        if create_mask is not None:
            # the rows of other ranks' pixels must not stay valid in the
            # appended chunks
            create = create & create_mask
            new_data.i[:, _VALID] = create.to(torch.int32)

        # ---- creations: compact to the front (pixel order kept), append ----
        # The block of mc_eff rows is appended at the cursor in chunks of
        # ch rows: chunk c lands iff the whole append fits the view and the
        # arena and it holds creations (JAX's rule). Written in fixed size:
        # the rows of the chunks that do not land are written with their
        # own values, at their positions modulo the view, which no landing
        # row takes (mc_eff <= the fresh region <= the view).
        n_chunks = 4 if mc_eff % 4 == 0 else 1
        ch = mc_eff // n_chunks
        n_new = torch.sum(create)
        perm = torch.sort((~create).to(torch.int32), stable=True).indices
        take = perm[:mc_eff]
        blk_f, blk_i = new_data.f[take], new_data.i[take]

        active_count = state.active_count.to(torch.int64)
        chunks_needed = (n_new + ch - 1) // ch
        end_row = active_count + chunks_needed * ch
        last_slot = torch.clamp((end_row - 1) // bs, 0, k - 1).reshape(1)
        arena_ok = (state.active_blocks[last_slot] < nb).reshape(())
        a_fit = (end_row <= view_rows) & arena_ok
        n_created = torch.where(a_fit, n_new, 0)
        n_dropped = n_new - n_created

        # fresh tensors from _update_finish: write in place
        av, ai = upd.f, upd.i
        offs = torch.arange(mc_eff, device=dev)
        lands = (a_fit & (offs < chunks_needed * ch))[:, None]
        pos = (active_count + offs) % view_rows
        av[pos] = torch.where(lands, blk_f, av[pos])
        ai[pos] = torch.where(lands, blk_i, ai[pos])
        active2 = PackedSurfels(f=av, i=ai)

        poses = state.poses  # updated in place
        slot = torch.clamp(ts.to(torch.int64), 0, poses.shape[0] - 1)
        poses.index_copy_(0, slot.reshape(1), pose[None])

        state2 = state._replace(
            count=(state.count + n_created).to(torch.int32), poses=poses,
            active=active2,
            active_count=(active_count + n_created).to(torch.int32))

    # ---- model render from the shared z-buffer ----
    with span(stopwatch, "fuse/render"):
        has = winner_render >= 0
        g = upd.f[winner_render.clamp_min(0)]
        gl = upd.i[winner_render.clamp_min(0), _LABEL]
        r_inv, t_inv = pose_inv[:3, :3], pose_inv[:3, 3]
        p_c = g[:, _WPOS] @ r_inv.T + t_inv
        n_c = g[:, _WNRM] @ r_inv.T
        img = torch.cat([p_c, n_c, g[:, _RADIUS:_RADIUS + 1],
                         gl[:, None].to(torch.float32),
                         g[:, _SEMPROB:_SEMPROB + 1]], dim=-1)
        img = torch.where(has[:, None], img, 0.0)

        if group is not None:
            # depth-min merge of the ranks' render candidates
            d_all = group.gather(wdepth_render)                 # [D, HW]
            img_all = group.gather(img)                         # [D, HW, 9]
            win = torch.argmin(d_all, dim=0)
            img = torch.take_along_dim(img_all, win[None, :, None], dim=0)[0]
            wdepth_render = torch.amin(d_all, dim=0)
            has = torch.isfinite(wdepth_render)

        # merge this scan's creations (they splat exactly at their pixel)
        maps = frame.maps
        vflat = maps.vertex.reshape(-1, 3)
        nflat = maps.normal.reshape(-1, 3)
        d_new = torch.linalg.norm(vflat, dim=-1)
        cos_new = torch.sum(nflat * (-vflat), dim=-1) \
            / torch.clamp_min(d_new, 1e-12)
        conf_new = torch.where(
            is_movable(maps.sem_label.reshape(-1)) & semantic,
            map_cfg.log_prior - 0.5, map_cfg.log_prior)
        if group is not None and create_mask is not None:
            # a created pixel renders iff its owner rank had room for it
            owner_fit = group.sum((create_mask & a_fit).to(torch.int32)) > 0
            new_rsel = create_all & owner_fit & (cos_new > 0.01)
        else:
            new_rsel = create & a_fit & (cos_new > 0.01)
        if map_cfg.use_stability:
            new_rsel = new_rsel & (conf_new > confidence_threshold)
        take_new = new_rsel & (~has | (d_new < wdepth_render))
        new_img = torch.cat([
            vflat, nflat, frame.radius.reshape(-1, 1),
            maps.sem_label.reshape(-1, 1).to(torch.float32),
            maps.sem_prob.reshape(-1, 1)], dim=-1)
        img = torch.where(take_new[:, None], new_img, img)
        has = has | take_new

        h, w = data_cfg.height, data_cfg.width
        model_maps = _disk_resolve(img.reshape(h, w, 9), has.reshape(h, w),
                                   data_cfg, map_cfg.splat_resolve_radius)
    return state2, model_maps, n_created, n_dropped


def update_map(state: MapState, frame: FrameInputs, pose: torch.Tensor,
               timestamp, data_cfg: DataConfig, map_cfg: MapConfig,
               confidence_threshold, semantic: bool = True):
    """Map update without the render output; returns a SYNCED state and the
    number of surfels created (a device tensor)."""
    state2, _, n_created, _ = fuse_and_render(
        state, frame, pose, timestamp, data_cfg, map_cfg,
        confidence_threshold, int(timestamp) + 1, semantic)
    return sync(state2, map_cfg), n_created


def _reset_view(state: MapState, cfg: MapConfig) -> MapState:
    """Drop the (already synced) view; the anchor -> inf forces a refresh
    before the next append."""
    bs, nb, k, f_blocks = _geometry(cfg)
    dev = state.poses.device
    return state._replace(
        active_blocks=_fresh_view(nb, k, f_blocks,
                                  state.block_count.to(torch.int64), dev),
        active=make_packed(k * bs, dev),
        active_count=torch.full((), (k - f_blocks) * bs, dtype=torch.int32,
                                device=dev),
        anchor=torch.full((3,), torch.inf, dtype=torch.float32, device=dev))


def compact(state: MapState, cfg: MapConfig) -> MapState:
    """Stream compaction of the global store (drops dead rows and block
    padding, keeping row order); the active view is invalidated."""
    state = sync(state, cfg)
    bs = _geometry(cfg)[0]
    d = state.data
    perm = torch.sort((~d.valid).to(torch.int32), stable=True).indices
    n_valid = torch.sum(d.valid).to(torch.int32)
    state = state._replace(
        data=PackedSurfels(f=d.f[perm], i=d.i[perm]), count=n_valid,
        block_count=((n_valid + bs - 1) // bs).to(torch.int32))
    return _reset_view(state, cfg)


def update_poses(state: MapState, new_poses: torch.Tensor,
                 cfg: MapConfig) -> MapState:
    """Rewrite the pose table after loop closure and refresh the cached
    world-frame geometry (surfels are never touched, only poses).
    Invalidates the active view. The input state stays valid."""
    state = sync(state, cfg)  # a copy of the store: written in place below
    d = state.data
    new_poses = new_poses.to(torch.float32)
    cp = new_poses[torch.clamp(d.creation_ts.to(torch.int64), 0,
                               new_poses.shape[0] - 1)]
    f = d.f
    f[:, _WPOS] = torch.einsum("nij,nj->ni", cp[:, :3, :3], d.position) \
        + cp[:, :3, 3]
    f[:, _WNRM] = torch.einsum("nij,nj->ni", cp[:, :3, :3], d.normal)
    state = state._replace(data=PackedSurfels(f=f, i=d.i), poses=new_poses)
    return _reset_view(state, cfg)
