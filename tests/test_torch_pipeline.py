"""The port's odometry path against the JAX package at ``small()`` with the
bilateral filter on.

* One ``fuse_and_render`` step from a converted mid-run JAX state: counts,
  view blocks and integer surfel columns exact, surfel floats and model maps
  at atol 1e-4 (model-map pixels where an ulp-level depth difference picks
  another winner allowed up to 0.5%); ``compact``, ``refresh_active`` and
  ``update_map`` from the same state.
* 20 scans of ``odometry_step``. Each scan starts the port from the JAX
  state of the same scan (converted with ``convert.slam_state_from_numpy``):
  every pose within 1e-3 m and 1e-3 rad of JAX, the same Gauss-Newton
  iteration count and the same map count. Run freely instead, the two
  trajectories drift apart by centimetres over 20 scans, as the JAX package
  does from itself when its input moves by one ulp (a Gauss-Newton loop that
  stops at its iteration cap amplifies rounding), so the free run is held
  only on the final map count, within 0.5%.
* ``SurfelSLAM`` builds a spill manager, a loop closer and a chunking
  session when asked, and refuses a missing GPU.
* A session without spill compacts when the arena's free rows fall under
  the headroom, even where the live count is far from the capacity (the
  JAX package's single-device rule would wait; its sharded rule is this
  one); a session with spill keeps the single-device rule.
"""
import torch_env  # noqa: F401  (first: one torch thread)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_shared
from semantic_suma_tpu.config import (LoopClosureConfig as JLoop,
                                      MapConfig as JMap,
                                      PreprocessConfig as JPre,
                                      SumaConfig as JConfig)
from semantic_suma_tpu.core import pipeline as jp
from semantic_suma_tpu.core import surfel_map as jsm
from semantic_suma_tpu.io import simulation as jsim
from semantic_suma_tpu_torch.config import (LoopClosureConfig, MapConfig,
                                            PreprocessConfig, SumaConfig)
from semantic_suma_tpu_torch.convert import (maps_from_numpy,
                                             slam_state_from_numpy)
from semantic_suma_tpu_torch.core import pipeline as tp
from semantic_suma_tpu_torch.core import surfel_map as tsm

N_SCANS = 20


def _configs():
    jcfg = JConfig(map=JMap(spill_enabled=False), loop=JLoop(enabled=False),
                   preprocess=JPre(use_filtered_vertexmap=True)).small()
    cfg = SumaConfig(map=MapConfig(spill_enabled=False),
                     loop=LoopClosureConfig(enabled=False),
                     preprocess=PreprocessConfig(use_filtered_vertexmap=True)
                     ).small()
    return jcfg, cfg


def _t(a):
    return torch.from_numpy(np.array(a))


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX trajectory, with the port stepped from each JAX state and
    the port run freely beside it: computed once a run, for every xdist
    worker that runs a test of this file (``tests/torch_shared.py``)."""
    return torch_shared.once(tmp_path_factory, "pipeline-run",
                             lambda _: _run())


def _run():
    jcfg, cfg = _configs()
    world = jsim.default_world(0, extent=45.0)
    gt = jsim.circular_trajectory(N_SCANS, radius=18.0, step=1.5)
    step = jax.jit(jp.odometry_step, static_argnames=("cfg",))
    js = jp.init_state(jcfg)
    free = tp.init_state(cfg, "cpu")
    rows, mid = [], None
    for i in range(N_SCANS):
        ct = (1.0 - i / jcfg.map.time_init) * jcfg.map.log_unstable
        s = jsim.render_scan(world, gt[i], jcfg.data)
        inputs = (_t(s.points), _t(s.labels), _t(s.probs), _t(s.valid))
        if i == 8:
            mid = (_numpy(js), s, ct)
        forced = slam_state_from_numpy(_numpy(js), "cpu")
        _, ti = tp.odometry_step(forced, *inputs, ct, cfg)
        free, fi = tp.odometry_step(free, *inputs, ct, cfg)
        js, ji = step(js, s.points, s.labels, s.probs, s.valid, ct, jcfg)
        rows.append((_numpy(ji), ti, fi))
    return rows, mid


def test_odometry_step_matches_jax_per_scan(run):
    rows, _ = run
    for i, (ji, ti, _) in enumerate(rows):
        pj = ji.pose.astype(np.float64)
        pt = ti.pose.numpy().astype(np.float64)
        rel = np.linalg.inv(pj) @ pt
        np.testing.assert_allclose(pt[:3, 3], pj[:3, 3], atol=1e-3,
                                   err_msg=f"scan {i}")
        # angle from the antisymmetric part: the trace formula's arccos
        # cannot resolve angles below ~1e-3 rad from f32 rotations
        skew = np.array([rel[2, 1] - rel[1, 2], rel[0, 2] - rel[2, 0],
                         rel[1, 0] - rel[0, 1]])
        rot = float(np.arcsin(min(1.0, np.linalg.norm(skew) / 2)))
        assert rot <= 1e-3, (i, rot)
        assert ti.iterations == int(ji.iterations), i
        assert int(ti.map_count) == int(ji.map_count), i
        assert ti.n_dropped == int(ji.n_dropped) == 0
        assert ti.track_loss == bool(ji.track_loss), i


def test_free_run_map_count_within_half_percent(run):
    rows, _ = run
    ji, _, fi = rows[-1]
    mj, mt = int(ji.map_count), int(fi.map_count)
    assert abs(mt - mj) <= 0.005 * mj, (mt, mj)


def test_fuse_and_render_from_converted_state(run):
    _, (jstate, scan, ct) = run
    jcfg, cfg = _configs()
    ts = int(jstate.timestamp)
    jpre = jp.preprocess_scan(scan.points, scan.labels, scan.probs,
                              scan.valid, ts < jcfg.semantic.init_scans, jcfg)
    jframe = jsm.data_surfel_init(jpre, jcfg.data, jcfg.map)
    # the constant-velocity prediction stands in for the aligned pose
    pose = np.asarray(jstate.pose) @ np.asarray(jstate.last_increment)
    jmap = jax.tree.map(jnp.asarray, jstate.map)
    j2, jmodel, jn, jd = jsm.fuse_and_render(
        jmap, jframe, jnp.asarray(pose), ts, jcfg.data, jcfg.map, ct,
        ts + 1 - jcfg.loop.delta_timestamp)

    tstate = slam_state_from_numpy(jstate, "cpu")
    tframe = tsm.data_surfel_init(maps_from_numpy(_numpy(jpre), "cpu"),
                                  cfg.data, cfg.map)
    t2, tmodel, tn, td = tsm.fuse_and_render(
        tstate.map, tframe, torch.from_numpy(pose), ts, cfg.data, cfg.map,
        ct, ts + 1 - cfg.loop.delta_timestamp)
    assert (tn, td) == (int(jn), int(jd))
    assert int(t2.count) == int(j2.count)
    assert int(t2.active_count) == int(j2.active_count)
    np.testing.assert_array_equal(t2.active_blocks.numpy(),
                                  np.asarray(j2.active_blocks))
    np.testing.assert_array_equal(t2.active.i.numpy(), np.asarray(j2.active.i))
    np.testing.assert_allclose(t2.active.f.numpy(), np.asarray(j2.active.f),
                               atol=1e-4)
    # Model maps: flags and labels exact, floats at 1e-4. The surfel depths
    # the render sorts on differ from JAX's by an ulp (another summation
    # order in the pose transform), which can move a candidate across a
    # 0.38 mm depth bucket so that a near-duplicate surfel of the same pixel
    # wins: such pixels (0.24% here) are allowed up to 0.5%.
    off = np.zeros(tmodel.vertex_valid.shape, bool)
    for name in jmodel._fields:
        a, b = np.asarray(getattr(jmodel, name)), getattr(tmodel, name).numpy()
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            d = np.abs(b - a)
            off |= (d.max(-1) if d.ndim == 3 else d) > 1e-4
    assert off.mean() <= 0.005, off.sum()


def test_map_maintenance_matches_jax(run):
    _, (jstate, scan, ct) = run
    jcfg, cfg = _configs()
    jmap = jax.tree.map(jnp.asarray, jstate.map)

    def fresh():
        return slam_state_from_numpy(jstate.map, "cpu")

    def same(t, j):
        for name in ("count", "active_count", "block_count",
                     "active_blocks"):
            np.testing.assert_array_equal(getattr(t, name).numpy(),
                                          np.asarray(getattr(j, name)), name)
        for part in ("data", "active"):
            tp_, jp_ = getattr(t, part), getattr(j, part)
            np.testing.assert_array_equal(tp_.i.numpy(), np.asarray(jp_.i))
            np.testing.assert_allclose(tp_.f.numpy(), np.asarray(jp_.f),
                                       atol=1e-4)

    same(tsm.compact(fresh(), cfg.map), jsm.compact(jmap, jcfg.map))
    center = np.asarray(jstate.pose)[:3, 3] + np.float32([30.0, -20.0, 0.0])
    same(tsm.refresh_active(fresh(), torch.from_numpy(center), cfg.map),
         jsm.refresh_active(jmap, jnp.asarray(center), jcfg.map))

    ts = int(jstate.timestamp)
    jpre = jp.preprocess_scan(scan.points, scan.labels, scan.probs,
                              scan.valid, ts < jcfg.semantic.init_scans, jcfg)
    pose = np.asarray(jstate.pose) @ np.asarray(jstate.last_increment)
    j2, jn = jsm.update_map(
        jmap, jsm.data_surfel_init(jpre, jcfg.data, jcfg.map),
        jnp.asarray(pose), ts, jcfg.data, jcfg.map, ct)
    t2, tn = tsm.update_map(
        fresh(), tsm.data_surfel_init(maps_from_numpy(_numpy(jpre), "cpu"),
                                      cfg.data, cfg.map),
        torch.from_numpy(pose), ts, cfg.data, cfg.map, ct)
    assert tn == int(jn)
    same(t2, j2)


def test_surfel_slam_refuses_unported_paths():
    """No path of ``SurfelSLAM`` is refused any more: asked for, it builds a
    spill manager, a loop closer and a chunking session."""
    _, cfg = _configs()
    # spill is ported: asked for, ``SurfelSLAM`` builds a spill manager
    spilling = tp.SurfelSLAM(cfg.replace(map=dataclasses.replace(
        cfg.map, spill_enabled=True)), device="cpu")
    assert spilling.spill is not None and not spilling.spill.chunks
    assert tp.SurfelSLAM(cfg, device="cpu").spill is None
    # chunked dispatch is ported: asked for, ``SurfelSLAM`` chunks
    chunking = tp.SurfelSLAM(cfg, chunk_size=4, device="cpu")
    assert chunking.chunk_size == 4 and chunking._chunk_buf == []
    # loop closure is ported: asked for either way, ``SurfelSLAM`` builds one
    for slam in (tp.SurfelSLAM(dataclasses.replace(
                     cfg, loop=LoopClosureConfig()), device="cpu"),
                 tp.SurfelSLAM(cfg, enable_loop_closure=True, device="cpu")):
        assert slam._loop is not None and slam._loop.pipelined_ok
        assert slam._loop.device.type == "cpu"
    assert tp.SurfelSLAM(cfg, device="cpu")._loop is None
    f2f = tp.SurfelSLAM(dataclasses.replace(cfg, approach="frame-to-frame"),
                        enable_loop_closure=True, device="cpu")
    assert f2f._loop is None


def test_entry_points_need_a_gpu_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    _, cfg = _configs()
    with pytest.raises(RuntimeError):
        tp.SurfelSLAM(cfg)
    with pytest.raises(RuntimeError):
        tp.init_state(cfg)
    slam = tp.SurfelSLAM(cfg, device="cpu")
    assert slam.state.pose.device.type == "cpu"


@pytest.mark.parametrize("spill", [False, True])
def test_session_without_spill_compacts_on_free_rows(spill):
    """A drained scan whose counters say: 0 live rows, every block but one
    scan's rows allocated (dead rows and the fresh region), nothing
    dropped."""
    cfg = SumaConfig(map=MapConfig(spill_enabled=spill),
                     loop=LoopClosureConfig(enabled=False)).small()
    slam = tp.SurfelSLAM(cfg, device="cpu")
    rows = cfg.data.height * cfg.data.width
    bs = cfg.map.effective_block_size
    vec = np.zeros(50, np.float32)
    vec[0:16] = vec[16:32] = np.eye(4, dtype=np.float32).reshape(-1)
    tail = vec[32:]
    tail[12] = 3                                                # iterations
    tail[16] = 0                                                # map_count
    tail[17] = (cfg.map.surfel_capacity - rows) // bs           # block_count
    version0 = slam.map_version
    slam._finish_host(vec, 0.0)
    assert slam.creations_dropped == 0
    if spill:  # the live count is far from the capacity: no compaction
        assert slam.map_version == version0
    else:
        assert slam.map_version == version0 + 1
