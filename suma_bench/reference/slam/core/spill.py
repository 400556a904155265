"""Host-RAM spill for the surfel arena (counterpart of
``semantic_suma_tpu/core/spill.py``): unbounded map scale on a bounded
device arena.

* When the arena nears capacity, the farthest allocated blocks (beyond the
  active radius plus a margin) are gathered to the host in whole-block
  chunks, marked dead on the device, and the store is stream-compacted.
* Each chunk keeps its rows in the creation-pose frame with the creation
  pose index, so a loop-closure rebase never touches spilled rows: only the
  chunk centroids are recomputed from the new pose table.
* When the vehicle (or a loop-closure verification view) comes near a
  chunk's centroid again, the chunk is appended at the arena's tail with its
  world-frame cache re-derived from the current pose table.

The device work is four plain functions on the port's ``MapState`` (sync and
score, score only, extract and kill, insert); chunks are host numpy arrays.

Two departures from the JAX package:

* the asynchronous eligibility probe is keyed to the map version of the
  state it scored (``SurfelSLAM.map_version``: bumped by a page-in, a spill,
  a compaction and a rebase, which renumber blocks or move them, and not by
  the growth of the arena, which adds blocks near the vehicle). A verdict
  read against another version is dropped and the call decides on the
  current state, as a call without a probe does. The JAX package reads such
  a verdict as it is;
* ``ensure_resident`` takes the caller's headroom: a chunk is paged in only
  if the rows that the next scans may create still fit after it, else room
  is made first or the chunk waits on the host. The JAX package pages a
  chunk in up to the arena's last block, and the next scan's creations
  can then find no room.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..config import MapConfig
from ..device import AsyncFetch, to_host
from . import surfel_map as sm
from .surfel_map import _CTS, _NRM, _POS, _VALID, _WNRM, _WPOS, _geometry


def _block_dmin(d: sm.PackedSurfels, center: torch.Tensor,
                cfg: MapConfig) -> torch.Tensor:
    """Per-block min distance to ``center`` over valid rows [NB], inf where
    a block holds none."""
    bs, nb, _, _ = _geometry(cfg)
    dist = torch.linalg.norm(d.wpos.reshape(nb, bs, 3) - center, dim=-1)
    return torch.amin(torch.where(d.valid.reshape(nb, bs), dist, torch.inf),
                      dim=1)


def _sync_and_score(state: sm.MapState, center: torch.Tensor,
                    cfg: MapConfig):
    """Write the view back, then return (synced_state, per-block min
    distance to ``center`` over valid rows [NB], inf where empty)."""
    state = sm.sync(state, cfg)
    return state, _block_dmin(state.data, center, cfg)


def _score_blocks(state: sm.MapState, center: torch.Tensor,
                  cfg: MapConfig) -> torch.Tensor:
    """The same distances over the ARENA rows, without the view writeback:
    active blocks' arena copies are stale, but spill eligibility masks them
    out anyway. This is the cheap asynchronous probe that detects futile
    attempts (nothing beyond the keep radius)."""
    return _block_dmin(state.data, center, cfg)


def _extract_blocks(state: sm.MapState, ids: torch.Tensor, cfg: MapConfig):
    """Gather whole blocks out of the SYNCED store and mark them dead; ids
    >= num_blocks are pads and gather invalid rows. The store is written in
    place (``sync`` made it a copy). Returns (state', rows_f [S*bs, 16],
    rows_i [S*bs, 4])."""
    bs, nb, _, _ = _geometry(cfg)
    rows = sm._block_take(state.data, ids, bs)
    n_out = torch.sum(rows.valid).to(torch.int32)
    real = ids[ids < nb]
    state.data.i.reshape(nb, bs, sm.NUM_I)[real, :, _VALID] = 0
    return state._replace(count=state.count - n_out), rows.f, rows.i


def _insert_chunk(state: sm.MapState, rows_f: torch.Tensor,
                  rows_i: torch.Tensor, cfg: MapConfig) -> sm.MapState:
    """Append a spilled chunk (whole blocks of rows in the creation frame) at
    the arena tail, its world cache re-derived from the CURRENT pose table.
    The caller guarantees block_count + S <= num_blocks. The view is
    reset."""
    bs = _geometry(cfg)[0]
    state = sm.sync(state, cfg)  # a copy of the store: written in place
    poses = state.poses
    cp = poses[torch.clamp(rows_i[:, _CTS].to(torch.int64), 0,
                           poses.shape[0] - 1)]
    rows_f = rows_f.clone()
    rows_f[:, _WPOS] = torch.einsum("nij,nj->ni", cp[:, :3, :3],
                                    rows_f[:, _POS]) + cp[:, :3, 3]
    rows_f[:, _WNRM] = torch.einsum("nij,nj->ni", cp[:, :3, :3],
                                    rows_f[:, _NRM])
    off = to_host(state.block_count) * bs
    n = rows_f.shape[0]
    state.data.f[off:off + n] = rows_f
    state.data.i[off:off + n] = rows_i
    n_in = torch.sum(rows_i[:, _VALID] > 0).to(torch.int32)
    state = state._replace(count=state.count + n_in,
                           block_count=state.block_count + n // bs)
    return sm._reset_view(state, cfg)


class SpillChunk:
    """One spilled unit: whole blocks of packed rows (host numpy) and a
    world centroid."""

    def __init__(self, f: np.ndarray, i: np.ndarray):
        self.f = f
        self.i = i
        self.n_valid = int((i[:, _VALID] > 0).sum())
        self.centroid = self._centroid_from_cache()

    def _centroid_from_cache(self) -> np.ndarray:
        v = self.i[:, _VALID] > 0
        if not v.any():
            return np.full((3,), np.inf, np.float32)
        return self.f[v][:, _WPOS].mean(axis=0)

    def recompute_centroid(self, poses: np.ndarray) -> None:
        """After a pose-graph rebase: re-derive the centroid from the
        creation-frame geometry and the NEW pose table (the rows never
        change)."""
        v = self.i[:, _VALID] > 0
        if not v.any():
            return
        cts = np.clip(self.i[v, _CTS], 0, len(poses) - 1)
        cp = poses[cts]
        wpos = np.einsum("nij,nj->ni", cp[:, :3, :3], self.f[v][:, _POS]) \
            + cp[:, :3, 3]
        self.centroid = wpos.mean(axis=0).astype(np.float32)


class SpillManager:
    """Host-side paging policy and chunk store for one SLAM session.

    ``SurfelSLAM`` calls :meth:`maybe_spill` after each scan (a no-op unless
    the arena is nearly full) and :meth:`ensure_resident` with any position
    whose surroundings must be on the device (the current pose every scan; a
    loop candidate's old pose before an old-map render).
    """

    def __init__(self, cfg: MapConfig, chunk_blocks: int = 8,
                 spill_margin: float = 25.0, unspill_margin: float = 25.0):
        bs, nb, k, _ = _geometry(cfg)
        self.cfg = cfg
        self.chunk_blocks = max(1, min(chunk_blocks, nb // 2))
        self.spill_margin = spill_margin
        self.unspill_margin = unspill_margin
        self.chunks: List[SpillChunk] = []
        self.chunks_paged_in = 0
        self.probes = 0           # asynchronous probes dispatched
        self.futile_verdicts = 0  # probe verdicts: nothing to evict
        self.stale_verdicts = 0   # verdicts dropped: the map version moved
        self._bs, self._nb, self._k = bs, nb, k
        # in-flight probe: (AsyncFetch of the distances, map version scored)
        self._probe = None

    @property
    def spilled_rows(self) -> int:
        return sum(c.n_valid for c in self.chunks)

    def on_rebase(self, poses: np.ndarray) -> None:
        for c in self.chunks:
            c.recompute_centroid(np.asarray(poses, np.float32))

    # -- spilling ----------------------------------------------------------

    @property
    def probe_pending(self) -> bool:
        """True while an asynchronous eligibility probe is in flight: the
        caller must not arm its futile-retry threshold yet (the verdict is
        read on the next ``maybe_spill`` call)."""
        return self._probe is not None

    def maybe_spill(self, state: sm.MapState, center: np.ndarray,
                    headroom_rows: int, async_probe: bool = False,
                    version: int = 0) -> Optional[sm.MapState]:
        """If fewer than ``headroom_rows`` free rows remain, evict far blocks
        to host RAM and compact. Returns the new state, or None if nothing
        was done (the state is untouched).

        With ``async_probe`` (``SurfelSLAM`` with scans in flight, unless
        creations are already dropping) the futile case under pressure is
        detected by an asynchronous probe: the first pressured call dispatches
        ``_score_blocks`` and returns None with ``probe_pending`` set; the
        next call reads its verdict. Only a verdict that something lies
        beyond the keep radius pays the synchronous sync + score + extract
        path, which re-scores on the current state. A verdict scored at
        another ``version`` of the map than the caller's is dropped
        unread."""
        cfg = self.cfg
        bs, nb = self._bs, self._nb
        free_rows = cfg.surfel_capacity - to_host(state.block_count) * bs
        if free_rows >= headroom_rows:
            self._probe = None
            return None

        keep_radius = cfg.active_radius + self.spill_margin
        center_t = torch.as_tensor(np.asarray(center, np.float32),
                                   device=state.poses.device)
        if async_probe:
            if self._probe is None:
                self._probe = (AsyncFetch(_score_blocks(state, center_t,
                                                        cfg)), version)
                self.probes += 1
                return None
            fetch, scored_at = self._probe
            self._probe = None
            pd = fetch.wait()
            if scored_at != version:
                self.stale_verdicts += 1
            elif not (np.isfinite(pd) & (pd > keep_radius)).any():
                self.futile_verdicts += 1
                return None  # futile: the caller arms its retry threshold

        self._probe = None  # any outstanding probe is superseded
        state, dmin = _sync_and_score(state, center_t, cfg)
        dmin = AsyncFetch(dmin).wait()
        active = AsyncFetch(state.active_blocks).wait()
        in_view = np.zeros(nb + self._k, bool)
        in_view[active] = True
        eligible = np.where(np.isfinite(dmin) & (dmin > keep_radius)
                            & ~in_view[:nb])[0]
        if eligible.size == 0:
            return None
        # farthest first, whole chunks
        eligible = eligible[np.argsort(-dmin[eligible])]
        n_goal = max(self.chunk_blocks,
                     min(eligible.size,
                         (headroom_rows - free_rows + bs - 1) // bs))
        took = 0
        while took < n_goal and took < eligible.size:
            ids = eligible[took:took + self.chunk_blocks]
            ids = np.pad(ids, (0, self.chunk_blocks - ids.size),
                         constant_values=nb)  # pads gather as invalid
            state, rf, ri = _extract_blocks(
                state, torch.as_tensor(ids, device=state.poses.device), cfg)
            # keep only the blocks that hold valid rows, so that a page-in
            # takes ceil(n_valid / bs) arena blocks, not chunk_blocks blocks
            # of mostly padding
            rf_np, ri_np = AsyncFetch(rf).wait(), AsyncFetch(ri).wait()
            v = ri_np[:, _VALID] > 0
            nv = int(v.sum())
            if nv:
                order = np.argsort(~v, kind="stable")
                keep = -(-nv // bs) * bs
                self.chunks.append(SpillChunk(rf_np[order][:keep],
                                              ri_np[order][:keep]))
            took += self.chunk_blocks
        return sm.compact(state, cfg)

    # -- unspilling --------------------------------------------------------

    def ensure_resident(self, state: sm.MapState, center: np.ndarray,
                        headroom_rows: int = 0) -> Optional[sm.MapState]:
        """Page back every chunk whose centroid lies within the active
        radius (+ margin) of ``center`` and that leaves ``headroom_rows``
        free rows behind it (0: up to the last block, as the JAX package
        does). Returns the new state, or None."""
        if not self.chunks:
            return None
        cfg = self.cfg
        bs = self._bs
        radius = cfg.active_radius + self.unspill_margin
        center = np.asarray(center, np.float32)
        near = [c for c in self.chunks
                if np.linalg.norm(c.centroid - center) < radius]
        if not near:
            return None
        changed = False
        dev = state.poses.device
        cap = cfg.surfel_capacity
        for chunk in near:
            need = chunk.f.shape[0] + headroom_rows
            if to_host(state.block_count) * bs + need > cap:
                # make room: evict far blocks first; if the map near the
                # vehicle fills the arena, leave the chunk out
                spilled = self.maybe_spill(state, center,
                                           headroom_rows=need + bs)
                if spilled is None:
                    continue
                state = spilled
                changed = True
                if to_host(state.block_count) * bs + need > cap:
                    continue
            state = _insert_chunk(state, torch.as_tensor(chunk.f, device=dev),
                                  torch.as_tensor(chunk.i, device=dev), cfg)
            self.chunks.remove(chunk)
            self.chunks_paged_in += 1
            changed = True
        return state if changed else None
