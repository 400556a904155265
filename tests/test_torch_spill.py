"""The port's host-RAM spill (``core/spill.py``) against the JAX package on
the CPU.

* At the tiny arena of ``tests/test_spill.py`` (24x120, 2^15 rows, 4-block
  chunks) and from one converted JAX map holding two far-apart regions:
  ``maybe_spill`` extracts the same block ids in the same order, with the
  same chunk rows (integers exact, floats within 1e-6 m) and the same
  ``count`` / ``block_count`` after compaction; ``ensure_resident`` gives
  the same counts exactly and the world cache within 1e-5 m (the page-in
  re-derives it from the pose table: one einsum in each package, whose
  summation order may differ by an ulp); ``on_rebase`` moves the chunk
  centroids as JAX does, within 1e-4 m.
* The asynchronous probe gives the JAX verdicts (pending, futile, spill,
  cleared), also on a map that grew since the probe. Where the port departs
  from JAX: a verdict scored at another map version (a page-in, spill,
  compaction or rebase came between) is dropped and the call decides on the
  current state (JAX reads the stale verdict as it is).
* The second departure: ``ensure_resident`` with a headroom pages a chunk
  in only if that many rows stay free behind it, evicting far blocks first
  (JAX, headroom 0, pages in up to the last block).
* ``convert.spill_from_jax``: from a JAX ``SurfelSLAM`` converted one scan
  before a page-in, both packages take that scan to the same ``count``,
  ``block_count``, spilled rows and chunks paged in.
* The port alone over the 80-scan forced-spill loop of
  ``test_loop_closes_after_forced_spill``, with that test's bounds on the
  spill, the page-in, the closures, the dropped creations (1%) and the
  final error, and at most one scan that drops.
"""
import torch_env  # noqa: F401  (first: one torch thread)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_suma_tpu.config import (DataConfig as JData, IcpConfig as JIcp,
                                      LoopClosureConfig as JLoop,
                                      MapConfig as JMap, SumaConfig as JConfig)
from semantic_suma_tpu.core import pipeline as jp
from semantic_suma_tpu.core import spill as jsp
from semantic_suma_tpu.core import surfel_map as jsm
from semantic_suma_tpu.io import simulation as jsim
from semantic_suma_tpu.ops.filters import compute_normals
from semantic_suma_tpu.ops.icp import Maps
from semantic_suma_tpu.ops.projection import project_scan
from semantic_suma_tpu_torch.config import (MapConfig, SumaConfig,
                                            forced_spill_config,
                                            forced_spill_sections)
from semantic_suma_tpu_torch.convert import (map_state_from_numpy,
                                             slam_state_from_numpy,
                                             spill_from_jax)
from semantic_suma_tpu_torch.core import spill as tsp
from semantic_suma_tpu_torch.core.pipeline import SurfelSLAM
from semantic_suma_tpu_torch.io.simulation import SimulationReader, rich_world

CFG = JData(width=120, height=24)
_MAP = dict(surfel_capacity=1 << 15, active_capacity=1 << 13, max_poses=64,
            submap_dimension=1, submap_extent=4.0, spill_margin=6.0,
            unspill_margin=6.0, spill_chunk_blocks=4)
JMCFG = JMap(**_MAP)
TMCFG = MapConfig(**_MAP)


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _ingest(state, x, ts, world):
    """One noise-free scan at (x, 0, 0) fused into a JAX map."""
    pose = np.eye(4, dtype=np.float32)
    pose[0, 3] = x
    pose = jnp.asarray(pose)
    scan = jsim.render_scan(world, pose, CFG)
    res = project_scan(scan.points, scan.labels, scan.probs, cfg=CFG,
                       point_valid=scan.valid)
    normal, nvalid = compute_normals(res.vertex_map, res.vertex_valid)
    maps = Maps(res.vertex_map, normal, res.vertex_valid, nvalid,
                res.sem_label, res.sem_prob)
    frame = jsm.data_surfel_init(maps, CFG, JMCFG)
    state, _ = jsm.update_map(state, frame, pose, ts, CFG, JMCFG, 0.0)
    return state


@pytest.fixture(scope="module")
def two_regions():
    """A synced JAX map of two regions 40 m apart (numpy leaves), and the
    same map with a third scan at 20 m (another ``block_count``)."""
    world = jsim.default_world(seed=0)
    state = jsm.empty_map(JMCFG)
    state = _ingest(state, 0.0, 0, world)
    state = jsm.sync(_ingest(state, 40.0, 1, world), JMCFG)
    grown = jsm.sync(_ingest(state, 20.0, 2, world), JMCFG)
    return _numpy(state), _numpy(grown)


def _port(np_state):
    return map_state_from_numpy(np_state, "cpu")


def _record_ids(monkeypatch, module):
    """Block ids handed to ``module._extract_blocks``, call by call."""
    calls = []
    orig = module._extract_blocks

    def recorded(state, ids, cfg, *rest):
        calls.append(np.asarray(ids).tolist())
        return orig(state, ids, cfg, *rest)

    monkeypatch.setattr(module, "_extract_blocks", recorded)
    return calls


def _same_store(t, j, float_tol):
    """Port and JAX stores: counts and integer columns exact, floats within
    ``float_tol``."""
    assert int(t.count) == int(j.count)
    assert int(t.block_count) == int(j.block_count)
    np.testing.assert_array_equal(t.data.i.numpy(), np.asarray(j.data.i))
    np.testing.assert_allclose(t.data.f.numpy(), np.asarray(j.data.f),
                               rtol=0, atol=float_tol)


FAR = np.array([40.0, 0.0, 0.0], np.float32)
ORIGIN = np.zeros(3, np.float32)


def _spilled(two_regions, monkeypatch):
    """Both packages spill the converted map under forced pressure at FAR
    (the region at the origin is beyond the keep radius)."""
    state, _ = two_regions
    j_ids = _record_ids(monkeypatch, jsp)
    t_ids = _record_ids(monkeypatch, tsp)
    jm = jsp.SpillManager(JMCFG, chunk_blocks=4, spill_margin=6.0,
                          unspill_margin=6.0)
    tm = tsp.SpillManager(TMCFG, chunk_blocks=4, spill_margin=6.0,
                          unspill_margin=6.0)
    js = jm.maybe_spill(jax.tree.map(jnp.asarray, state), FAR,
                        headroom_rows=JMCFG.surfel_capacity)
    ts = tm.maybe_spill(_port(state), FAR,
                        headroom_rows=TMCFG.surfel_capacity)
    return jm, tm, js, ts, j_ids, t_ids


def test_maybe_spill_matches_jax(two_regions, monkeypatch):
    jm, tm, js, ts, j_ids, t_ids = _spilled(two_regions, monkeypatch)
    assert js is not None and ts is not None
    assert t_ids == j_ids and len(j_ids) >= 1
    assert len(tm.chunks) == len(jm.chunks) >= 1
    for tc, jc in zip(tm.chunks, jm.chunks):
        np.testing.assert_array_equal(tc.i, jc.i)
        np.testing.assert_allclose(tc.f, jc.f, rtol=0, atol=1e-6)
        assert tc.n_valid == jc.n_valid
        np.testing.assert_allclose(tc.centroid, jc.centroid, rtol=0,
                                   atol=1e-6)
    assert tm.spilled_rows == jm.spilled_rows > 0
    _same_store(ts, js, 1e-6)


def test_ensure_resident_matches_jax(two_regions, monkeypatch):
    jm, tm, js, ts, _, _ = _spilled(two_regions, monkeypatch)
    # a position far from every chunk pages nothing in
    away = np.array([200.0, 0.0, 0.0], np.float32)
    assert tm.ensure_resident(ts, away) is None
    assert jm.ensure_resident(js, away) is None
    # back at the origin: the chunks there come back
    js2 = jm.ensure_resident(js, ORIGIN)
    ts2 = tm.ensure_resident(ts, ORIGIN)
    assert js2 is not None and ts2 is not None
    assert tm.chunks_paged_in == jm.chunks_paged_in >= 1
    assert len(tm.chunks) == len(jm.chunks)
    assert tm.spilled_rows == jm.spilled_rows
    # world cache re-derived from the pose table: 1e-5 m
    _same_store(ts2, js2, 1e-5)
    assert int(ts2.active_count) == int(js2.active_count)
    assert torch.isinf(ts2.anchor).all() and bool(jnp.isinf(js2.anchor).all())


def test_on_rebase_matches_jax(two_regions, monkeypatch):
    jm, tm, _, _, _, _ = _spilled(two_regions, monkeypatch)
    poses = np.tile(np.eye(4, dtype=np.float32), (64, 1, 1))
    poses[:, 0, 3] = 100.0   # every creation pose moves by +100 m in x
    poses[1, 0, 3] = 140.0
    poses[0, :3, :3] = [[0, -1, 0], [1, 0, 0], [0, 0, 1]]  # and one turns
    jm.on_rebase(poses)
    tm.on_rebase(poses)
    for tc, jc in zip(tm.chunks, jm.chunks):
        np.testing.assert_allclose(tc.centroid, jc.centroid, rtol=0,
                                   atol=1e-4)


def _managers(margin):
    return (jsp.SpillManager(JMCFG, chunk_blocks=4, spill_margin=margin),
            tsp.SpillManager(TMCFG, chunk_blocks=4, spill_margin=margin))


def test_async_probe_matches_jax(two_regions):
    state, _ = two_regions
    jstate = jax.tree.map(jnp.asarray, state)
    cap = JMCFG.surfel_capacity
    # futile: nothing beyond an impossible keep radius
    jm, tm = _managers(1e6)
    for m, st in ((jm, jstate), (tm, _port(state))):
        assert m.maybe_spill(st, ORIGIN, cap, async_probe=True) is None
        assert m.probe_pending
        assert m.maybe_spill(st, ORIGIN, cap, async_probe=True) is None
        assert not m.probe_pending and not m.chunks
    assert (tm.probes, tm.futile_verdicts, tm.stale_verdicts) == (1, 1, 0)
    # a verdict that something lies beyond the keep radius: a real spill
    jm, tm = _managers(6.0)
    got = []
    for m, st in ((jm, jstate), (tm, _port(state))):
        assert m.maybe_spill(st, FAR, cap, async_probe=True) is None
        assert m.probe_pending
        out = m.maybe_spill(st, FAR, cap, async_probe=True)
        assert out is not None and m.spilled_rows > 0
        assert not m.probe_pending
        # no pressure: the probe state clears
        assert m.maybe_spill(out, FAR, headroom_rows=1,
                             async_probe=True) is None
        assert not m.probe_pending
        got.append((int(out.count), int(out.block_count), m.spilled_rows))
    assert got[0] == got[1]


def test_stale_probe_verdict_is_dropped(two_regions):
    """The port's first departure from JAX. Keep radius 6 + 20 = 26 m around
    the origin: every block of the map of the scan at 0 m has a surfel
    within 18.5 m of it (futile), the map that also holds the scans at 40 m
    and 20 m has blocks whose nearest surfel is 38 m away. A probe
    dispatched on the first map and read on the second: JAX reads the
    futile verdict and spills nothing. The port reads it so too while the
    map version is the same (the arena only grew), and drops it when the
    version moved (a page-in, spill, compaction or rebase came between):
    then it spills what a synchronous call on that map spills."""
    world = jsim.default_world(seed=0)
    # compacted: the view holds no map block, so that every block is a
    # candidate for eviction
    near = _numpy(jsm.compact(_ingest(jsm.empty_map(JMCFG), 0.0, 0, world),
                              JMCFG))
    grown = _numpy(jsm.compact(jax.tree.map(jnp.asarray, two_regions[1]),
                               JMCFG))
    assert int(near.block_count) != int(grown.block_count)
    cap = JMCFG.surfel_capacity
    jm, tm = _managers(20.0)
    assert jm.maybe_spill(jax.tree.map(jnp.asarray, near), ORIGIN, cap,
                          async_probe=True) is None
    assert tm.maybe_spill(_port(near), ORIGIN, cap, async_probe=True,
                          version=3) is None
    # JAX: the stale futile verdict decides
    assert jm.maybe_spill(jax.tree.map(jnp.asarray, grown), ORIGIN, cap,
                          async_probe=True) is None
    assert not jm.chunks
    # the port, another version: dropped, decided on the current map
    out = tm.maybe_spill(_port(grown), ORIGIN, cap, async_probe=True,
                         version=4)
    assert (tm.probes, tm.stale_verdicts, tm.futile_verdicts) == (1, 1, 0)
    assert out is not None and tm.spilled_rows > 0
    sync_m = tsp.SpillManager(TMCFG, chunk_blocks=4, spill_margin=20.0)
    want = sync_m.maybe_spill(_port(grown), ORIGIN, cap)
    assert (int(out.count), int(out.block_count), tm.spilled_rows) == \
        (int(want.count), int(want.block_count), sync_m.spilled_rows)
    # the same version on a map that grew: read as JAX reads it
    tm2 = tsp.SpillManager(TMCFG, chunk_blocks=4, spill_margin=20.0)
    assert tm2.maybe_spill(_port(near), ORIGIN, cap, async_probe=True,
                           version=3) is None
    assert tm2.maybe_spill(_port(grown), ORIGIN, cap, async_probe=True,
                           version=3) is None
    assert (tm2.stale_verdicts, tm2.futile_verdicts) == (0, 1)
    assert not tm2.chunks


def test_page_in_keeps_headroom(two_regions, monkeypatch):
    """The port's second departure from JAX. Back at the origin after the
    region there was spilled: without a headroom the port pages the chunks
    in as JAX does (``test_ensure_resident_matches_jax``). With a headroom
    that the page-in would leave short by one row, it first evicts the
    region at 40 m (beyond the keep radius of the origin) and then pages
    the same chunks in, leaving the headroom free; with a headroom that no
    eviction can make, the chunks stay on the host."""
    jm, tm, js, ts, _, _ = _spilled(two_regions, monkeypatch)
    bs = tm._bs
    cap = TMCFG.surfel_capacity
    js2 = jm.ensure_resident(js, ORIGIN)
    free_jax = cap - int(js2.block_count) * bs
    paged = jm.chunks_paged_in
    # one row short: the port makes room first
    headroom = free_jax + 1
    ts2 = tm.ensure_resident(ts, ORIGIN, headroom_rows=headroom)
    assert ts2 is not None
    assert tm.chunks_paged_in == paged >= 1
    assert cap - int(ts2.block_count) * bs >= headroom
    assert int(ts2.count) < int(js2.count)
    far = [c for c in tm.chunks
           if np.linalg.norm(c.centroid - FAR) < np.linalg.norm(c.centroid)]
    assert far and sum(c.n_valid for c in far) == \
        int(js2.count) - int(ts2.count)
    # no room to be made: the chunks near the origin wait on the host
    _, tm3, _, ts3, _, _ = _spilled(two_regions, monkeypatch)
    held = tm3.spilled_rows
    out = tm3.ensure_resident(ts3, ORIGIN, headroom_rows=cap)
    assert tm3.chunks_paged_in == 0 and tm3.spilled_rows >= held
    assert out is None or int(out.count) <= int(ts3.count)


# ---------------------------------------------------------------------------
# SurfelSLAM: the forced-spill loop of tests/test_spill.py
# ---------------------------------------------------------------------------

def loop_cfg(loops: bool = True):
    """``tests/test_spill.py``'s ``loop_cfg()`` (24x120, 2^15 rows)."""
    return forced_spill_config(24, 120, 1 << 15, 1 << 13, loops=loops)


def jax_loop_cfg(loops: bool = True) -> JConfig:
    s = forced_spill_sections(24, 120, 1 << 15, 1 << 13, loops=loops)
    d = JData(**s["data"])
    return JConfig(data=d, model=d, icp=JIcp(**s["icp"]),
                   map=JMap(**s["map"]), loop=JLoop(**s["loop"]))


def jax_rich_world():
    return jsim.World(boxes=tuple(jsim.Box(b.center, b.size, b.label)
                                  for b in rich_world().boxes))


def test_forced_spill_config_is_the_jax_tests():
    """The shared forced-spill configuration and world equal
    ``tests/test_spill.py``'s."""
    import tests.test_spill as ts
    assert jax_loop_cfg() == ts.loop_cfg()
    assert jax_rich_world() == ts.rich_world()


def test_loop_closes_after_forced_spill():
    """80 noisy scans of the 16 m circle at the tiny arena through
    ``process_scan``: the old map spills mid-lap (before scan 45), pages back
    on the revisit, the loop closes, at most 1% of the creations drop and
    the final position is within 1.5 m (the JAX test's bounds); and at most
    one scan drops (the policy reclaims at once after a drop). The JAX
    package drops 463 of 46,320 here, on the scan after a page-in filled
    the arena to its last block; the port pages in only with the drain's
    headroom free behind the chunk (ROADMAP section 3)."""
    cfg = loop_cfg()
    n = 80
    reader = SimulationReader(cfg.data, n_scans=n, world=rich_world(),
                              radius=16.0, step=1.6, noise_sigma=0.03, seed=2,
                              device="cpu")
    slam = SurfelSLAM(cfg, device="cpu")
    max_spilled, first_spill = 0, None
    for i in range(n):
        s = reader.read(i)
        slam.process_scan(s.points, s.labels, s.probs, s.valid)
        if slam.spill.spilled_rows and first_spill is None:
            first_spill = i
        max_spilled = max(max_spilled, slam.spill.spilled_rows)
    assert max_spilled > 0 and first_spill < 45, (max_spilled, first_spill)
    assert slam.spill.chunks_paged_in >= 1
    created = sum(st["surfels-created"] for st in slam.statistics)
    assert slam.creations_dropped <= 0.01 * created, \
        (slam.creations_dropped, created)
    dropping = [i for i, st in enumerate(slam.statistics)
                if st["creations-dropped"]]
    assert len(dropping) <= 1, dropping
    assert slam._loop.num_loop_closures >= 1
    est = slam.trajectory()
    gt = reader.poses.numpy().astype(np.float64)
    rel = np.linalg.inv(gt[0]) @ gt[n - 1]
    err = np.linalg.norm(est[n - 1][:3, 3] - rel[:3, 3])
    assert err < 1.5, err
    laps = slam.stopwatch.summary()
    for name in ("host/page-in", "host/spill-out", "host/spill-compact"):
        assert laps[name]["count"] >= 1, name


N_BEFORE = 53   # the JAX run pages a chunk back in at scan 53 (0-based)


def test_spill_from_jax_continues_like_jax():
    """A JAX ``SurfelSLAM`` (loops off, spill on) over 53 noise-free scans of
    the forced-spill circle, converted into the port's with
    ``convert.spill_from_jax``; then both take scan 53, which pages a chunk
    back in: the same ``count``, ``block_count``, spilled rows and chunks
    paged in."""
    jslam = jp.SurfelSLAM(jax_loop_cfg(loops=False))
    reader = jsim.SimulationReader(jslam.cfg.data, n_scans=80,
                                   world=jax_rich_world(), radius=16.0,
                                   step=1.6, seed=2)
    for i in range(N_BEFORE):
        s = reader.read(i)
        jslam.process_scan(s.points, s.labels, s.probs, s.valid)
    assert jslam.spill.chunks, "the JAX run has not spilled yet"

    tslam = SurfelSLAM(loop_cfg(loops=False), device="cpu")
    tslam.state = slam_state_from_numpy(_numpy(jslam.state), "cpu")
    tslam.poses = [np.asarray(p) for p in jslam.poses]
    tslam.trajectory_distances = list(jslam.trajectory_distances)
    tslam._dispatched = jslam._dispatched
    tslam._spill_retry_blocks = jslam._spill_retry_blocks
    spill_from_jax(jslam.spill, tslam.spill, version=tslam.map_version)
    assert tslam.spill.spilled_rows == jslam.spill.spilled_rows
    assert tslam.spill.chunks_paged_in == jslam.spill.chunks_paged_in

    paged = jslam.spill.chunks_paged_in
    s = reader.read(N_BEFORE)
    jslam.process_scan(s.points, s.labels, s.probs, s.valid)
    tslam.process_scan(*(torch.as_tensor(np.array(x))
                         for x in (s.points, s.labels, s.probs, s.valid)))
    jmap, tmap = jslam.state.map, tslam.state.map
    assert jslam.spill.chunks_paged_in > paged, "scan 53 paged nothing in"
    assert int(tmap.count) == int(jmap.count)
    assert int(tmap.block_count) == int(jmap.block_count)
    assert tslam.spill.spilled_rows == jslam.spill.spilled_rows
    assert tslam.spill.chunks_paged_in == jslam.spill.chunks_paged_in
    np.testing.assert_allclose(tslam.poses[-1], np.asarray(jslam.poses[-1]),
                               rtol=0, atol=1e-4)


def test_default_config_drives_scans_with_spill_on():
    """``SurfelSLAM(SumaConfig())`` (here at ``small()``'s 32x180) builds
    with the package default ``spill_enabled`` and drives scans."""
    cfg = SumaConfig().small()
    assert SumaConfig().map.spill_enabled and cfg.map.spill_enabled
    slam = SurfelSLAM(cfg, device="cpu")
    assert slam.spill is not None and slam._loop is not None
    reader = SimulationReader(cfg.data, n_scans=3, step=1.0, device="cpu")
    for i in range(3):
        s = reader.read(i)
        slam.process_scan(s.points, s.labels, s.probs, s.valid)
    slam.finalize()
    est = slam.trajectory()
    assert est.shape == (3, 4, 4) and np.isfinite(est).all()
    gt = reader.poses.numpy()
    rel = np.linalg.inv(gt[0]) @ gt[2]
    assert np.linalg.norm(est[2][:3, 3] - rel[:3, 3]) < 0.05
