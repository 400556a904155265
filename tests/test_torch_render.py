"""The port's out-of-band map operations (loop closure's renders) against the
JAX package, from a JAX mid-run state at ``small()`` converted with
``convert.slam_state_from_numpy``.

* ``build_view`` and ``refresh_active(priority="old", ts_threshold=...)``:
  integer columns and the chosen blocks exact, floats at atol 1e-5; the block
  choice on a seeded score vector with ties and ``-inf`` entries equals
  ``jax.lax.top_k``'s (lowest index first among equals).
* ``render_view("old")``, ``render_maps`` (old and new), ``render_composed``:
  validity and labels equal outside 0.1% of the pixels (measured: 0 to 2
  pixels of 5760, at a wall's foot); vertices, normals and probabilities
  (atol 1e-5) equal outside at most 1.5% of the pixels, and at those pixels
  both packages show the same plane (normals within 1e-4, plane offsets
  within 2 mm). Measured 0.54% to 1.16%, also when both packages render the very
  same view rows: the tangent-disk resolve chooses among the surfels of
  neighbouring pixels by ray depth, surfels of one wall give ray depths
  equal to the last bits, and the two packages round those differently
  (``test_render_differences_are_ray_depth_ties`` is the witness: from the
  very same view rows the z-buffer winners agree at every differing pixel,
  and the two packages' choices among the nine neighbours lie within 2e-5 m
  of ray depth, at most 4.9e-7 relative: a few float32 roundings).
  ``render_index_map``: the same winners outside 0.5% of the pixels.
* ``compose_views`` exact; ``update_poses`` at atol 1e-5 with exact integers.
"""
import torch_env  # noqa: F401  (first: one torch thread)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_suma_tpu.config import (LoopClosureConfig as JLoop,
                                      MapConfig as JMap, SumaConfig as JConfig)
from semantic_suma_tpu.core import pipeline as jp
from semantic_suma_tpu.core import surfel_map as jsm
from semantic_suma_tpu.io import simulation as jsim
from semantic_suma_tpu.utils import lie as jlie
from semantic_suma_tpu_torch.config import (LoopClosureConfig, MapConfig,
                                            SumaConfig)
from semantic_suma_tpu_torch import convert
from semantic_suma_tpu_torch.convert import (maps_from_numpy,
                                             slam_state_from_numpy)
from semantic_suma_tpu_torch.core import surfel_map as tsm
from semantic_suma_tpu_torch.ops.projection import pixel_rays
from semantic_suma_tpu_torch.ops.zbuffer import zbuffer_argmin
from semantic_suma_tpu_torch.utils import lie

N_SCANS = 24
THR = N_SCANS - 10      # surfels created before scan 14 are "old"
CONF = -1.0


def _configs():
    jcfg = JConfig(map=JMap(spill_enabled=False),
                   loop=JLoop(enabled=False)).small()
    cfg = SumaConfig(map=MapConfig(spill_enabled=False),
                     loop=LoopClosureConfig(enabled=False)).small()
    return jcfg, cfg


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def mid():
    """The JAX state after 24 scans of a 14 m circle (so the first scans'
    surfels are seen again from the side), as JAX arrays and as the port's
    tensors, with the pose an old-map render would use."""
    jcfg, _ = _configs()
    world = jsim.default_world(0, extent=45.0)
    gt = jsim.circular_trajectory(N_SCANS, radius=14.0, step=1.5)
    step = jax.jit(jp.odometry_step, static_argnames=("cfg",))
    js = jp.init_state(jcfg)
    for i in range(N_SCANS):
        ct = (1.0 - i / jcfg.map.time_init) * jcfg.map.log_unstable
        s = jsim.render_scan(world, gt[i], jcfg.data)
        js, _ = step(js, s.points, s.labels, s.probs, s.valid, ct, jcfg)
    ts = slam_state_from_numpy(_numpy(js), "cpu")
    poses = np.asarray(js.map.poses)
    return js, ts, poses[6].copy(), np.asarray(js.pose).copy()


def _assert_maps_close(t, j, max_off=0.015):
    """Every field equal (floats at 1e-5) outside ``max_off`` of the pixels;
    where the label is the same and a float differs, both show the same
    plane."""
    off = np.zeros(t.vertex_valid.shape, bool)
    flags = np.zeros(t.vertex_valid.shape, bool)
    for name in j._fields:
        a, b = np.asarray(getattr(j, name)), getattr(t, name).numpy()
        if a.dtype.kind in "biu":
            flags |= a != b
        else:
            d = np.abs(b - a)
            off |= (d.max(-1) if d.ndim == 3 else d) > 1e-5
    assert flags.mean() <= 0.001, flags.sum()    # measured: 0 to 2 pixels
    assert (off | flags).mean() <= max_off, (off.sum(), off.size)
    assert int(t.vertex_valid.sum()) > 0.05 * off.size  # a real render
    same = off & ~flags
    if same.any():
        nt, nj = t.normal.numpy()[same], np.asarray(j.normal)[same]
        np.testing.assert_allclose(nt, nj, atol=1e-4)
        np.testing.assert_allclose(
            np.sum(nt * t.vertex.numpy()[same], -1),
            np.sum(nj * np.asarray(j.vertex)[same], -1), atol=2e-3)


def _assert_packed_close(t, j):
    np.testing.assert_array_equal(t.i.numpy(), np.asarray(j.i))
    np.testing.assert_allclose(t.f.numpy(), np.asarray(j.f), atol=1e-5)


def test_top_blocks_breaks_ties_like_lax_top_k():
    rng = np.random.default_rng(0)
    score = np.round(rng.uniform(-30, 0, size=64), 0).astype(np.float32)
    score[rng.uniform(size=64) < 0.4] = -np.inf      # ties and -inf entries
    for n in (8, 40, 64):
        js, ji = jax.lax.top_k(jnp.asarray(score), n)
        ts, ti = tsm._top_blocks(torch.from_numpy(score), n)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("n_blocks", [4, 8])
def test_build_view_matches_jax(mid, n_blocks):
    js, ts, old_pose, _ = mid
    jcfg, cfg = _configs()
    center = old_pose[:3, 3]
    jv = jsm.build_view(js.map, jnp.asarray(center), jcfg.map, n_blocks,
                        ts_threshold=THR)
    tv = tsm.build_view(ts.map, torch.from_numpy(center), cfg.map, n_blocks,
                        ts_threshold=THR)
    _assert_packed_close(tv, jv)
    assert int(tv.valid.sum()) > 100
    assert bool((tv.creation_ts[tv.valid] < THR).all())
    # a copy: writing the view leaves the store alone
    before = ts.map.data.f.clone()
    tv.f.zero_()
    assert torch.equal(ts.map.data.f, before)


def test_refresh_active_old_priority_matches_jax(mid):
    js, ts, old_pose, _ = mid
    jcfg, cfg = _configs()
    center = old_pose[:3, 3]
    j2 = jsm.refresh_active(js.map, jnp.asarray(center), jcfg.map,
                            priority="old", ts_threshold=THR)
    t2 = tsm.refresh_active(ts.map, torch.from_numpy(center), cfg.map,
                            priority="old", ts_threshold=THR)
    np.testing.assert_array_equal(t2.active_blocks.numpy(),
                                  np.asarray(j2.active_blocks))
    assert int(t2.active_count) == int(j2.active_count)
    assert int(t2.block_count) == int(j2.block_count)
    _assert_packed_close(t2.active, j2.active)


def test_render_view_old_matches_jax(mid):
    js, ts, old_pose, _ = mid
    jcfg, cfg = _configs()
    center = old_pose[:3, 3]
    jv = jsm.build_view(js.map, jnp.asarray(center), jcfg.map, 8,
                        ts_threshold=THR)
    tv = tsm.build_view(ts.map, torch.from_numpy(center), cfg.map, 8,
                        ts_threshold=THR)
    jm = jsm.render_view(jv, jnp.asarray(old_pose), jcfg.model, jcfg.map,
                         CONF, THR, "old")
    tm = tsm.render_view(tv, torch.from_numpy(old_pose), cfg.model, cfg.map,
                         CONF, THR, "old")
    _assert_maps_close(tm, jm)


@pytest.mark.parametrize("render_old", [False, True])
def test_render_maps_matches_jax(mid, render_old):
    js, ts, old_pose, cur_pose = mid
    jcfg, cfg = _configs()
    pose = old_pose if render_old else cur_pose
    jm = jsm.render_maps(js.map, jnp.asarray(pose), jcfg.model, jcfg.map,
                         CONF, THR, render_old=render_old)
    tm = tsm.render_maps(ts.map, torch.from_numpy(pose), cfg.model, cfg.map,
                         CONF, THR, render_old=render_old)
    _assert_maps_close(tm, jm)


def test_render_composed_matches_jax(mid):
    js, ts, old_pose, cur_pose = mid
    jcfg, cfg = _configs()
    jm = jsm.render_composed(js.map, jnp.asarray(cur_pose),
                             jnp.asarray(cur_pose), jcfg.model, jcfg.map,
                             CONF, THR)
    tm = tsm.render_composed(ts.map, torch.from_numpy(cur_pose),
                             torch.from_numpy(cur_pose), cfg.model, cfg.map,
                             CONF, THR)
    _assert_maps_close(tm, jm)


def _neighbour_ray_depths(tv, pose, cfg, which):
    """The port's dense z-buffer winner image for one view, and for each of
    the (2R+1)^2 neighbour offsets of the tangent-disk resolve: the ray depth
    ``t`` of that neighbour's surfel along the pixel's own ray, computed in
    float64 from the float32 winner image, its position, and whether the
    neighbour exists. Shapes [K, H, W(, 3)]."""
    dc = cfg.model
    h, w = dc.height, dc.width
    proj = tsm._project_surfels(
        tv, lie.se3_inverse(torch.from_numpy(pose).float()), dc)
    sel = tsm._selection(tv, proj, cfg.map, CONF, THR, which)
    winner, _ = zbuffer_argmin(
        torch.where(sel, proj.py * w + proj.px, -1),
        torch.where(sel, proj.depth, torch.inf), h * w,
        depth_bound=max(100.0, dc.max_depth))
    has = (winner >= 0).reshape(h, w).numpy()
    img = torch.where((winner >= 0)[:, None],
                      torch.cat([proj.p_c, proj.n_c], -1)[winner.clamp_min(0)],
                      0.0).reshape(h, w, 6).numpy().astype(np.float64)
    rays = pixel_rays(dc, device="cpu").numpy().astype(np.float64)
    rr = cfg.map.splat_resolve_radius
    ts, ps, oks = [], [], []
    for dy in range(-rr, rr + 1):
        rolled, rh = np.roll(img, -dy, 0), np.roll(has, -dy, 0).copy()
        if dy > 0:
            rh[h - dy:] = False
        elif dy < 0:
            rh[:-dy] = False
        for dx in range(-rr, rr + 1):
            nb = np.roll(rolled, -dx, 1)
            den = (nb[..., 3:6] * rays).sum(-1)
            den = np.where(np.abs(den) < 1e-9, 1e-9, den)
            ts.append((nb[..., 3:6] * nb[..., :3]).sum(-1) / den)
            ps.append(nb[..., :3])
            oks.append(np.roll(rh, -dx, 1))
    return np.stack(ts), np.stack(ps), np.stack(oks)


@pytest.mark.parametrize("case", ["verify-view", "model-view", "search-view"])
def test_render_differences_are_ray_depth_ties(mid, case):
    """Why up to 1.5% of a render's pixels differ from JAX's. Both packages
    render the very same view rows (the JAX view, converted). At every pixel
    where the vertices differ, JAX's choice is one of the nine neighbours of
    the port's own winner image (so the z-buffer winners agree there), and
    the ray depths of the two choices, recomputed in float64, lie within
    1e-6 relative (measured: at most 4.9e-7, 1.9e-5 m; medians 4e-8 to
    5e-8): ``_disk_resolve`` takes the nearer by a float32 comparison of
    depths that equal each other to a few roundings, and XLA and PyTorch
    round the dot products differently."""
    js, _, old_pose, cur_pose = mid
    jcfg, cfg = _configs()
    if case == "verify-view":
        pose, which = old_pose, "old"
        jv = jsm.build_view(js.map, jnp.asarray(pose[:3, 3]), jcfg.map, 8,
                            ts_threshold=THR)
    elif case == "search-view":
        pose, which = old_pose, "old"
        jv = jsm.refresh_active(js.map, jnp.asarray(pose[:3, 3]), jcfg.map,
                                priority="old", ts_threshold=THR).active
    else:
        pose, which = cur_pose, "new"
        jv = jsm.refresh_active(js.map, jnp.asarray(pose[:3, 3]), jcfg.map,
                                priority="new").active
    tv = convert._packed(_numpy(jv), "cpu")
    np.testing.assert_array_equal(tv.f.numpy(), np.asarray(jv.f))
    jm = jsm.render_view(jv, jnp.asarray(pose), jcfg.model, jcfg.map, CONF,
                         THR, which)
    tm = tsm.render_view(tv, torch.from_numpy(pose), cfg.model, cfg.map, CONF,
                         THR, which)
    np.testing.assert_array_equal(tm.vertex_valid.numpy(),
                                  np.asarray(jm.vertex_valid))
    vj = np.asarray(jm.vertex).astype(np.float64)
    vt = tm.vertex.numpy().astype(np.float64)
    differ = tm.vertex_valid.numpy() & (np.abs(vj - vt).max(-1) > 1e-5)
    assert 0 < differ.mean() <= 0.015
    ts, ps, oks = _neighbour_ray_depths(tv, pose, cfg, which)
    for y, x in zip(*np.nonzero(differ)):
        dj = np.where(oks[:, y, x], np.abs(ps[:, y, x] - vj[y, x]).max(-1),
                      np.inf)
        dt = np.where(oks[:, y, x], np.abs(ps[:, y, x] - vt[y, x]).max(-1),
                      np.inf)
        kj, kt = int(np.argmin(dj)), int(np.argmin(dt))
        assert dj[kj] <= 1e-5 and dt[kt] <= 1e-5, (y, x)   # same winners
        assert kj != kt
        assert abs(ts[kj, y, x] - ts[kt, y, x]) <= 1e-6 * ts[kt, y, x], (y, x)


def test_render_index_map_matches_jax(mid):
    js, ts, _, cur_pose = mid
    jcfg, cfg = _configs()
    inv = np.asarray(jlie.se3_inverse(jnp.asarray(cur_pose)))
    ji = np.asarray(jsm.render_index_map(js.map, jnp.asarray(inv),
                                         jcfg.model, jcfg.map))
    ti = tsm.render_index_map(ts.map, torch.from_numpy(inv), cfg.model,
                              cfg.map).numpy()
    assert ti.shape == ji.shape
    np.testing.assert_array_equal(ti >= 0, ji >= 0)
    assert (ti != ji).mean() <= 0.005
    assert (ti >= 0).mean() > 0.05


def test_compose_views_exact(mid):
    js, ts, old_pose, cur_pose = mid
    jcfg, cfg = _configs()
    j_old = jsm.render_maps(js.map, jnp.asarray(old_pose), jcfg.model,
                            jcfg.map, CONF, THR, render_old=True)
    j_new = js.model_maps
    # the same inputs on both sides, so the merge itself is held exactly
    t_old = maps_from_numpy(_numpy(j_old), "cpu")
    t_new = maps_from_numpy(_numpy(j_new), "cpu")
    for maxd in (8.0, 0.5):
        jc = jsm.compose_views(j_old, j_new, maxd)
        tc = tsm.compose_views(t_old, t_new, maxd)
        for name in jc._fields:
            np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                          np.asarray(getattr(jc, name)), name)
    took_old = tc.vertex_valid & ~t_new.vertex_valid
    assert int(took_old.sum()) > 0


def test_update_poses_matches_jax(mid):
    js, ts, _, _ = mid
    jcfg, cfg = _configs()
    rng = np.random.default_rng(1)
    poses = np.asarray(js.map.poses).copy()
    for k in range(N_SCANS):        # a smooth correction, growing with time
        twist = np.float32([0.02, -0.01, 0.0, 0.0, 0.0, 0.003]) * k \
            + rng.normal(0, 1e-3, 6).astype(np.float32)
        poses[k] = np.asarray(jlie.se3_exp(jnp.asarray(twist))) @ poses[k]
    j2 = jsm.update_poses(js.map, jnp.asarray(poses), jcfg.map)
    before = ts.map.data.f.clone()
    t2 = tsm.update_poses(ts.map, torch.from_numpy(poses), cfg.map)
    assert torch.equal(ts.map.data.f, before)   # the input state stays valid
    _assert_packed_close(t2.data, j2.data)
    _assert_packed_close(t2.active, j2.active)
    np.testing.assert_array_equal(t2.active_blocks.numpy(),
                                  np.asarray(j2.active_blocks))
    np.testing.assert_array_equal(t2.poses.numpy(), np.asarray(j2.poses))
    assert int(t2.active_count) == int(j2.active_count)
    assert not bool(torch.isfinite(t2.anchor).any())
