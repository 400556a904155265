"""The port's loop closure against the JAX package on the CPU, at the 24x120
``loop_cfg`` of ``tests/test_loop_closure.py``.

* The three programs (``verify``, ``verify_chain``, ``search``) against the
  JAX programs on one converted state after a full lap: packed vectors with
  poses within 1e-4 (5e-4 for ``search``, whose three levels each stop at
  the iteration cap), the increment's log within 1e-4, counts within 0.5% of
  the image, errors within 2%, the gate bit equal; the composed maps they
  return equal outside 1.5% of the pixels. And ``verify`` and ``search``
  against the port's own unfused path (poses 1e-5, counts within 0.5%).
* The state machine with scripted inputs: the same sequence of step infos
  and stubbed program outputs (numpy) drives the JAX ``LoopCloser`` and the
  port's in ``SurfelSLAM``'s calling order, synchronously (``lag`` 0) and
  with two scans in flight (``lag`` 2): the same candidates, edges, counters
  and ``sync_request`` scan by scan; the optimized poses within 1e-3.
* The path as a whole on the port alone: a 75-scan noisy circle through
  ``process_scan`` and through ``process_scan_async`` + ``finalize()`` closes
  loops and ends within 1.0 m of ground truth; a straight run closes none;
  ``finalize()`` on a zero-scan run returns.
"""
import torch_env  # noqa: F401  (first: one torch thread)

from collections import deque

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_suma_tpu.config import (DataConfig as JData, IcpConfig as JIcp,
                                      LoopClosureConfig as JLoop,
                                      MapConfig as JMap, SumaConfig as JConfig)
from semantic_suma_tpu.core import pipeline as jp
from semantic_suma_tpu.core import surfel_map as jsm
from semantic_suma_tpu.core.loop_closure import LoopCloser as JLoopCloser
from semantic_suma_tpu.io import simulation as jsim
from semantic_suma_tpu.ops import icp as jicp
from semantic_suma_tpu_torch.config import (DataConfig, IcpConfig,
                                            LoopClosureConfig, MapConfig,
                                            SumaConfig)
from semantic_suma_tpu_torch.convert import (loop_state_from_jax,
                                             slam_state_from_numpy)
from semantic_suma_tpu_torch.core import surfel_map as tsm
from semantic_suma_tpu_torch.core.loop_closure import LoopCloser
from semantic_suma_tpu_torch.core.pipeline import (HostStepInfo, SurfelSLAM,
                                                   _pack_step_info,
                                                   _unpack_step_info)
from semantic_suma_tpu_torch.io.simulation import SimulationReader
from semantic_suma_tpu_torch.ops import icp as ticp
from semantic_suma_tpu_torch.utils import lie as tlie

_LOOP = dict(enabled=True, min_trajectory_distance=60.0, delta_timestamp=20,
             search_distance=20.0, min_verifications=3, outlier_threshold=6.0)
_MAP = dict(surfel_capacity=1 << 16, active_capacity=1 << 14, max_poses=256,
            spill_enabled=False)


def loop_cfg():
    d = DataConfig(width=120, height=24)
    return SumaConfig(data=d, model=d, icp=IcpConfig(max_iterations=10),
                      map=MapConfig(**_MAP), loop=LoopClosureConfig(**_LOOP))


def jax_loop_cfg():
    d = JData(width=120, height=24)
    return JConfig(data=d, model=d, icp=JIcp(max_iterations=10),
                   map=JMap(**_MAP), loop=JLoop(**_LOOP))


HW = 24 * 120
N_LAP = 66      # one lap of the 16 m circle at 1.6 m a scan is ~63 scans


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# (d) the three programs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lap():
    """The JAX odometry state after 66 noisy scans of the circle (the vehicle
    is back at its start), converted; with the programs of both packages."""
    jcfg, cfg = jax_loop_cfg(), loop_cfg()
    reader = jsim.SimulationReader(jcfg.data, n_scans=N_LAP, radius=16.0,
                                   step=1.6, noise_sigma=0.03, seed=2)
    step = jax.jit(jp.odometry_step, static_argnames=("cfg",))
    js = jp.init_state(jcfg)
    poses = []
    for i in range(N_LAP):
        t = i / jcfg.map.time_init
        ct = (1.0 - t) * jcfg.map.log_unstable if t < 1 else 0.0
        s = reader.read(i)
        js, info = step(js, s.points, s.labels, s.probs, s.valid, ct, jcfg)
        poses.append(np.asarray(info.pose))
    jlc = JLoopCloser(jcfg)
    jlc._build_fused()
    tlc = LoopCloser(cfg, device="cpu")
    tlc._build_fused()
    ts = slam_state_from_numpy(_numpy(js), "cpu")
    return dict(js=js, ts=ts, poses=poses, jlc=jlc, tlc=tlc, jcfg=jcfg,
                cfg=cfg, thr=N_LAP - cfg.loop.delta_timestamp, conf=0.0)


def _views(lap, center, n_blocks=None):
    c = np.asarray(center, np.float32)
    if n_blocks is None:
        jv = jsm.refresh_active(lap["js"].map, jnp.asarray(c), lap["jcfg"].map,
                                priority="old",
                                ts_threshold=lap["thr"]).active
        tv = tsm.refresh_active(lap["ts"].map, torch.from_numpy(c),
                                lap["cfg"].map, priority="old",
                                ts_threshold=lap["thr"]).active
    else:
        jv = jsm.build_view(lap["js"].map, jnp.asarray(c), lap["jcfg"].map,
                            n_blocks, ts_threshold=lap["thr"])
        tv = tsm.build_view(lap["ts"].map, torch.from_numpy(c),
                            lap["cfg"].map, n_blocks,
                            ts_threshold=lap["thr"])
    return jv, tv


def _assert_vec_close(t, j, pose_slices, count_idx, error_idx, log_slice=None,
                      pose_atol=1e-4):
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    for sl in pose_slices:
        np.testing.assert_allclose(t[sl], j[sl], atol=pose_atol)
    if log_slice is not None:
        np.testing.assert_allclose(t[log_slice], j[log_slice], atol=1e-4)
    np.testing.assert_allclose(t[count_idx], j[count_idx], atol=0.005 * HW)
    np.testing.assert_allclose(t[error_idx], j[error_idx], rtol=0.02,
                               atol=1e-3)
    assert j[count_idx].max() > 0.3 * HW      # a real association


_COUNTS = [23, 24, 25, 27, 29, 30, 31, 33]
_ERRORS = [22, 26, 28, 32]


def _maps_off(t, j):
    off = np.zeros(t.vertex_valid.shape, bool)
    for name in j._fields:
        a, b = np.asarray(getattr(j, name)), getattr(t, name).numpy()
        d = np.abs(b.astype(np.float64) - a.astype(np.float64))
        off |= (d.max(-1) if d.ndim == 3 else d) > 1e-4
    return off.mean()


def test_verify_program_matches_jax(lap):
    js, ts = lap["js"], lap["ts"]
    prev = lap["poses"][-2]
    jv, tv = _views(lap, prev[:3, 3])
    jvec, jcomp = lap["jlc"]._fused[0](
        jv, jnp.asarray(lap["thr"], jnp.int32), jnp.asarray(prev),
        js.last_maps, js.model_maps, js.last_increment,
        jnp.asarray(lap["conf"], jnp.float32))
    tvec, tcomp = lap["tlc"]._fused[0](
        tv, lap["thr"], torch.from_numpy(prev), ts.last_maps, ts.model_maps,
        ts.last_increment, lap["conf"])
    assert tvec.shape == (50,) and tvec.dtype == torch.float32
    _assert_vec_close(tvec.numpy(), jvec, [slice(0, 16), slice(34, 50)],
                      _COUNTS, _ERRORS, slice(16, 22))
    assert _maps_off(tcomp, jcomp) <= 0.015


def test_verify_chain_program_matches_jax(lap):
    js, ts = lap["js"], lap["ts"]
    prev, cur = lap["poses"][-2], lap["poses"][-1]
    jv, tv = _views(lap, prev[:3, 3], n_blocks=8)   # half the view
    # an anchor that agrees with the old map (the previous scan's pose as the
    # old map sees it: one verification ahead of the drifted estimate), where
    # the gates pass; and one 3 m off, where they fail and the carry and the
    # composed output must fall back to the odometry side
    aligned = np.asarray(lap["jlc"]._fused[0](
        jv, jnp.asarray(lap["thr"], jnp.int32), jnp.asarray(prev),
        js.last_maps, js.model_maps, js.last_increment,
        jnp.asarray(lap["conf"], jnp.float32))[0])[34:50].reshape(4, 4)
    good = (aligned @ np.linalg.inv(np.asarray(js.last_increment))
            ).astype(np.float32)
    far = prev.copy()
    far[:3, 3] += np.float32([3.0, -3.0, 0.0])
    for anchor, want_gate in ((good, 1.0), (far, 0.0)):
        jvec, jcomp, jnext = lap["jlc"]._fused[2](
            jv, jnp.asarray(lap["thr"], jnp.int32), jnp.asarray(anchor),
            js.last_maps, js.model_maps, js.last_increment, jnp.asarray(cur),
            jnp.asarray(lap["conf"], jnp.float32))
        tvec, tcomp, tnext = lap["tlc"]._fused[2](
            tv, lap["thr"], torch.from_numpy(anchor), ts.last_maps,
            ts.model_maps, ts.last_increment, torch.from_numpy(cur),
            lap["conf"])
        assert tvec.shape == (51,)
        assert float(tvec[50]) == float(jvec[50]) == want_gate
        np.testing.assert_allclose(tnext.numpy(), np.asarray(jnext),
                                   atol=1e-4)
        assert _maps_off(tcomp, jcomp) <= 0.015
        if want_gate:
            _assert_vec_close(tvec.numpy(), jvec,
                              [slice(0, 16), slice(34, 50)], _COUNTS, _ERRORS,
                              slice(16, 22))
        else:
            np.testing.assert_array_equal(tnext.numpy(), cur)


def _search_inits(pose_prior, pose):
    o = np.linalg.inv(pose_prior) @ pose
    o[2, 3] = 0.0
    rot_only = o.copy()
    rot_only[:3, 3] = 0.0
    half = o.copy()
    half[0, 3] *= 0.5
    half[1, 3] *= 0.5
    return np.stack([o, rot_only, half]).astype(np.float32)


def test_search_program_matches_jax(lap):
    js, ts = lap["js"], lap["ts"]
    cur = lap["poses"][-1]
    early = np.stack(lap["poses"][:20])
    to = int(np.argmin(np.linalg.norm(early[:, :3, 3] - cur[:3, 3], axis=-1)))
    prior = lap["poses"][to]
    inits = _search_inits(prior, cur)
    jv, tv = _views(lap, prior[:3, 3])
    jrows = np.asarray(lap["jlc"]._fused[1](
        jv, jnp.asarray(lap["thr"], jnp.int32), jnp.asarray(prior),
        jnp.asarray(inits), js.last_maps, js.model_maps,
        jnp.asarray(lap["conf"], jnp.float32)))
    calls0 = ticp.gn_counts["calls"]
    trows = lap["tlc"]._fused[1](
        tv, lap["thr"], torch.from_numpy(prior), torch.from_numpy(inits),
        ts.last_maps, ts.model_maps, lap["conf"]).numpy()
    assert ticp.gn_counts["calls"] - calls0 == 9   # 3 inits x 3 levels
    assert trows.shape == jrows.shape == (3, 28)
    for k in range(3):
        # 5e-4: each row is three Gauss-Newton levels that end at the cap of
        # 10 iterations, not at convergence, so rounding is carried along
        # (measured 1.3e-4)
        _assert_vec_close(trows[k], jrows[k], [slice(0, 16)],
                          [17, 18, 19, 21, 23, 24, 25, 27], [16, 20, 22, 26],
                          pose_atol=5e-4)


def _port_slam(lap):
    """A port ``SurfelSLAM`` holding the converted state, as after ``N_LAP`` scans."""
    slam = SurfelSLAM(lap["cfg"], device="cpu")
    slam.state = slam_state_from_numpy(_numpy(lap["js"]), "cpu")
    slam.poses = [p.copy() for p in lap["poses"]]
    slam._dispatched = N_LAP
    return slam


def test_verify_program_matches_unfused_path(lap):
    slam = _port_slam(lap)
    lc = slam._loop
    lc._build_fused()
    prev, cur = lap["poses"][-2], lap["poses"][-1]
    view, thr = slam.old_view(prev)
    v = lc._fused[0](view, thr, torch.from_numpy(prev), slam.last_maps,
                     slam.model_maps, slam.last_increment,
                     slam.confidence_threshold())[0].numpy()
    old_maps = lc._render_old(slam, prev)
    res = ticp.gauss_newton(slam.last_maps, old_maps, slam.last_increment,
                            lap["cfg"].icp, lap["cfg"].model)
    np.testing.assert_allclose(v[:16].reshape(4, 4), res.pose.numpy(),
                               atol=1e-6)
    pose_old_new = prev @ res.pose.numpy()
    np.testing.assert_allclose(v[34:50].reshape(4, 4), pose_old_new,
                               atol=1e-5)
    cstats = lc._composed_residual(slam, pose_old_new, cur)
    got = v[28:34]
    want = np.float64([cstats.error, cstats.valid, cstats.inlier,
                       cstats.outlier, cstats.inlier_residual,
                       cstats.invalid])
    np.testing.assert_allclose(got[[1, 2, 3, 5]], want[[1, 2, 3, 5]],
                               atol=0.005 * HW)
    np.testing.assert_allclose(got[[0, 4]], want[[0, 4]], rtol=0.02)


def test_search_matches_unfused_path(lap):
    """``_search_candidate`` through the one-fetch program and through the
    unfused path picks the same candidate with the same anchor (1e-5)."""
    picked = []
    for fused in (True, False):
        slam = _port_slam(lap)
        slam.supports_fused_verify = fused
        lc = slam._loop
        slam.trajectory_distances = [0.0]
        for a, b in zip(lap["poses"][:-1], lap["poses"][1:]):
            slam.trajectory_distances.append(
                slam.trajectory_distances[-1]
                + float(np.linalg.norm(a[:3, 3] - b[:3, 3])))
        for k, p in enumerate(lap["poses"]):
            lc.posegraph.set_initial(k, p)
        # the odometry result's statistics: this scan against its own model
        st = ticp.evaluate(torch.eye(4), slam.last_maps, slam.model_maps,
                           lap["cfg"].icp, lap["cfg"].model)
        info = HostStepInfo(
            pose=lap["poses"][-1], increment=np.eye(4, dtype=np.float32),
            inc_log=np.zeros(6, np.float32),
            stats=ticp.IcpStats(*[float(x) for x in st]),
            iterations=3, track_loss=False, n_created=0, n_dropped=0,
            map_count=0, block_count=0)
        vr, orr, res = lc._ratios(info.stats)
        assert lc._search_candidate(slam, info, vr, orr, res)
        picked.append((lc.unverified[0], lc.pose_old))
    (ca, pa), (cb, pb) = picked
    assert (ca.frm, ca.to) == (cb.frm, cb.to) and ca.frm == N_LAP - 1
    np.testing.assert_allclose(pa, pb, atol=1e-5)
    np.testing.assert_allclose(ca.rel_pose, cb.rel_pose, atol=1e-5)


def test_pack_step_info_round_trip():
    rng = np.random.default_rng(0)
    pose = tlie.se3_exp(torch.from_numpy(rng.normal(0, 1, 6).astype("f4")))
    inc = tlie.se3_exp(torch.from_numpy(rng.normal(0, .1, 6).astype("f4")))
    from semantic_suma_tpu_torch.core.pipeline import StepInfo
    stats = ticp.IcpStats(torch.tensor(12.5), torch.tensor(2000),
                          torch.tensor(1900), torch.tensor(100),
                          torch.tensor(11.0), torch.tensor(345))
    info = StepInfo(pose=pose, increment=inc, stats=stats, iterations=7,
                    track_loss=True, n_created=321, n_dropped=2,
                    map_count=torch.tensor(54321), syncs=9)
    vec = _pack_step_info(info, torch.tensor(17))
    assert vec.shape == (50,) and vec.dtype == torch.float32
    # the layout of the JAX package's packed vector, field by field
    h = _unpack_step_info(vec.numpy())
    jh = jp._unpack_step_info(vec.numpy())
    for name in HostStepInfo._fields:
        a, b = getattr(h, name), getattr(jh, name)
        if name == "stats":
            assert tuple(a) == tuple(b)
        else:
            np.testing.assert_array_equal(a, b, name)
    np.testing.assert_allclose(h.inc_log, tlie.se3_log(inc).numpy(),
                               atol=1e-7)
    assert (h.iterations, h.track_loss, h.n_created, h.n_dropped,
            h.map_count, h.block_count) == (7, True, 321, 2, 54321, 17)


# ---------------------------------------------------------------------------
# (e) the state machine with scripted inputs
# ---------------------------------------------------------------------------

class _Scripted:
    """A stand-in for ``SurfelSLAM`` that feeds one ``LoopCloser`` scripted step infos in the
    order ``SurfelSLAM`` calls it, with stub programs whose outputs (numpy)
    are functions of their pose arguments. ``wrap`` turns a numpy array into
    what the closer under test expects from a program."""

    supports_fused_verify = True

    def __init__(self, lc, wrap, depth):
        self.lc, self.wrap, self.depth = lc, wrap, depth
        # a tiny all-invalid Maps of the closer's own package
        zero = wrap(np.zeros((2, 4, 3), np.float32))
        flag = wrap(np.zeros((2, 4), bool))
        maps_cls = ticp.Maps if wrap is torch.from_numpy else jicp.Maps
        self.maps = maps_cls(zero, zero, flag, flag,
                             wrap(np.zeros((2, 4), np.int32)),
                             wrap(np.zeros((2, 4), np.float32)))
        self.poses, self.trajectory_distances = [], [0.0]
        self.frame_correction = np.eye(4, dtype=np.float32)
        self.stopwatch = None
        self.pending = deque()
        self._dispatched = 0
        self.pose = np.eye(4, dtype=np.float32)
        self.last_increment = np.eye(4, dtype=np.float32)
        self.last_maps = self.model_maps = self.maps
        self.log = []
        self.rebases = []
        lc._fused = (self._verify, self._search, self._verify_chain)

    # -- what the closer reads from its host loop
    @property
    def timestamp(self):
        return len(self.poses)

    def old_view(self, pose, timestamp=None):
        return None, 0

    verify_view = old_view

    def render_old_maps(self, pose):
        return self.maps

    def confidence_threshold(self):
        return 0.0

    def _conf_at(self, t):
        return 0.0

    def set_model_maps(self, maps):
        self.model_maps = maps

    def rebase(self, new_poses, new_current):
        self.rebases.append(len(new_poses))
        self.pose = np.asarray(new_current, np.float32)
        for i in range(min(len(new_poses), len(self.poses))):
            self.poses[i] = np.asarray(new_poses[i])

    def flush(self):
        while self.pending:
            self._drain()

    # -- stub programs: a good alignment whose result is the odometry's
    _GOOD = np.float32([50.0, 2400.0, 2300.0, 100.0, 40.0, 300.0])

    def _verify(self, view, thr, last_pose_old, data, model, t0, conf):
        inc = np.asarray(t0, np.float32)
        new = np.asarray(last_pose_old, np.float32) @ inc
        log = tlie.se3_log(torch.from_numpy(inc)).numpy()
        vec = np.concatenate([inc.reshape(-1), log, self._GOOD, self._GOOD,
                              new.reshape(-1)]).astype(np.float32)
        return self.wrap(vec), self.maps

    def _verify_chain(self, view, thr, prev, data, model, inc, odo, conf):
        vec, _ = self._verify(view, thr, prev, data, model, inc, conf)
        vec = np.concatenate([np.asarray(vec), np.float32([1.0])])
        new = np.asarray(prev, np.float32) @ np.asarray(inc, np.float32)
        return self.wrap(vec), self.maps, self.wrap(new)

    def _search(self, view, thr, prior, inits, data, model, conf):
        prior = np.asarray(prior, np.float32)
        rows = [np.concatenate([(prior @ np.asarray(inits[k], np.float32)
                                 ).reshape(-1), self._GOOD, self._GOOD])
                for k in range(3)]
        return self.wrap(np.stack(rows).astype(np.float32))

    # -- ``SurfelSLAM``'s calling order
    def feed(self, info):
        lc = self.lc
        if lc._opt_future is not None:      # deterministic: wait, integrate
            lc._opt_future.result()
            lc.integrate(self)
        idx = self._dispatched
        self._dispatched += 1
        self.pose = info.pose
        self.last_increment = info.increment
        self.pending.append(info)
        if lc.chain_live and lc.pipelined_ok:
            lc.dispatch_verify(self, idx)
            if self.depth and lc.sync_needed:
                return self.flush()
        elif self.depth and lc.sync_needed:
            lc.pre_dispatch(self)
            return self.flush()
        elif not self.depth:
            lc.pre_dispatch(self)
        while len(self.pending) > self.depth:
            self._drain()

    def _drain(self):
        info = self.pending.popleft()
        info = info._replace(pose=self.frame_correction @ info.pose)
        self.poses.append(info.pose)
        if len(self.poses) > 1:
            self.trajectory_distances.append(
                self.trajectory_distances[-1] + float(np.linalg.norm(
                    self.poses[-2][:3, 3] - info.pose[:3, 3])))
        lc = self.lc
        stats = lc.on_scan(self, info, lag=len(self.pending))
        self.log.append((
            len(self.poses) - 1, len(self.pending), lc.sync_request,
            len(lc.unverified), lc.already_verified, lc.loop_count,
            lc.num_loop_closures, lc.time_without_loop,
            stats.get("loop-verifying"), stats.get("loop-candidate-found"),
            len(lc.posegraph._edges)))


def _script(n=78):
    """Step infos of a drifting 16 m circle (1.6 m a scan) from a seed."""
    rng = np.random.default_rng(7)
    gt = np.asarray(jsim.circular_trajectory(n, radius=16.0, step=1.6))
    pose = gt[0].astype(np.float32)
    infos = []
    for i in range(n):
        inc = np.eye(4, dtype=np.float32)
        if i:
            noise = tlie.se3_exp(torch.from_numpy(
                (rng.normal(0, 1, 6) * [4e-3, 4e-3, 1e-3, 2e-4, 2e-4, 8e-4]
                 ).astype(np.float32))).numpy()
            inc = (np.linalg.inv(gt[i - 1]) @ gt[i]).astype(np.float32) @ noise
            pose = pose @ inc
        stats = ticp.IcpStats(60.0 + i % 5, 2400.0, 2300.0, 100.0, 50.0,
                              300.0)
        infos.append(HostStepInfo(
            pose=pose.copy(), increment=inc,
            inc_log=tlie.se3_log(torch.from_numpy(inc)).numpy(), stats=stats,
            iterations=3, track_loss=False, n_created=100, n_dropped=0,
            map_count=1000 * i, block_count=i))
    return infos


@pytest.mark.parametrize("depth", [0, 2], ids=["lag0", "lag2"])
def test_state_machine_matches_jax(depth):
    jlc = JLoopCloser(jax_loop_cfg())
    tlc = LoopCloser(loop_cfg(), device="cpu")
    jlc.pipelined_ok = tlc.pipelined_ok = True
    jd = _Scripted(jlc, jnp.asarray, depth)
    td = _Scripted(tlc, torch.from_numpy, depth)
    for info in _script():
        jd.feed(info)
        td.feed(info)
    for d in (jd, td):
        d.flush()
        if d.lc._opt_future is not None:
            d.lc._opt_future.result()
            d.lc.integrate(d)
    assert td.log == jd.log
    if depth:
        assert any(row[1] > 0 for row in td.log)        # lag reached on_scan
        assert any(row[2] for row in td.log)            # a deferred search
    assert any(row[8] for row in td.log)                # verifications ran
    assert any(row[9] for row in td.log)                # a search found one
    for name in ("num_loop_closures", "num_optimizations", "num_rebases",
                 "num_soft_integrations", "loop_count", "time_without_loop",
                 "already_verified", "sync_request"):
        assert getattr(tlc, name) == getattr(jlc, name), name
    assert tlc.num_loop_closures >= 4 and tlc.num_optimizations >= 1
    assert td.rebases == jd.rebases
    je, te = jlc.posegraph._edges, tlc.posegraph._edges
    assert [(e[0], e[1], e[4]) for e in te] == [(e[0], e[1], e[4])
                                               for e in je]
    for a, b in zip(te, je):
        np.testing.assert_allclose(a[2], b[2], atol=1e-3)
    np.testing.assert_allclose(np.stack(td.poses), np.stack(jd.poses),
                               atol=1e-3)
    np.testing.assert_allclose(tlc.pose_old, jlc.pose_old, atol=1e-3)


def test_loop_state_from_jax_carries_the_host_state():
    jlc = JLoopCloser(jax_loop_cfg())
    jd = _Scripted(jlc, jnp.asarray, 0)
    infos = _script()
    for info in infos[:70]:
        jd.feed(info)
    tlc = loop_state_from_jax(jlc, LoopCloser(loop_cfg(), device="cpu"))
    assert len(tlc.posegraph._edges) == len(jlc.posegraph._edges)
    assert tlc.posegraph.size() == jlc.posegraph.size() == 70
    assert len(tlc.unverified) == len(jlc.unverified)
    assert tlc.already_verified == jlc.already_verified
    assert tlc.chain_live == jlc.chain_live
    np.testing.assert_array_equal(tlc.pose_old, jlc.pose_old)
    # both continue alike from the carried point
    td = _Scripted(tlc, torch.from_numpy, 0)
    td.poses = [p.copy() for p in jd.poses]
    td.trajectory_distances = list(jd.trajectory_distances)
    td._dispatched = jd._dispatched
    td.frame_correction = jd.frame_correction.copy()
    n0 = len(jd.log)
    for info in infos[70:]:
        jd.feed(info)
        td.feed(info)
    assert td.log == jd.log[n0:]


# ---------------------------------------------------------------------------
# (f) the path as a whole, port alone
# ---------------------------------------------------------------------------

def _drive(mode, n=75):
    cfg = loop_cfg()
    reader = SimulationReader(cfg.data, n_scans=n, radius=16.0, step=1.6,
                              noise_sigma=0.03, seed=2, device="cpu")
    slam = SurfelSLAM(cfg, device="cpu")
    assert slam._loop is not None and slam._loop.pipelined_ok
    for i in range(n):
        s = reader.read(i)
        if mode == "sync":
            out = slam.process_scan(s.points, s.labels, s.probs, s.valid)
            assert out is slam.statistics[-1] and len(slam.poses) == i + 1
        else:
            slam.process_scan_async(s.points, s.labels, s.probs, s.valid)
    return slam, reader


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_loop_closes_circle(mode):
    n = 75
    slam, reader = _drive(mode, n)
    slam.finalize()
    lc = slam._loop
    assert len(slam.poses) == n and not slam._pending
    assert lc.num_loop_closures >= 1, (
        lc.num_loop_closures, lc.time_without_loop, len(lc.unverified))
    assert lc.num_optimizations >= 1
    assert lc._opt_future is None
    assert len(lc.posegraph._edges) > slam.timestamp - 1
    est = slam.trajectory()
    assert np.isfinite(est).all()
    gt = reader.poses.numpy()
    rel_gt = np.linalg.inv(gt[0]) @ gt[n - 1]
    err = np.linalg.norm(est[n - 1][:3, 3] - rel_gt[:3, 3])
    assert err < 1.0, err
    if mode == "async":
        # verification ran with scans in flight (the device-carried chain)
        assert slam.stopwatch.stats["verify-dispatch"].count >= 4
    slam.finalize()     # idempotent
    assert np.isfinite(slam.trajectory()).all()
    assert len(slam.trajectory_distances) == n
    assert slam.map_version >= 1


def test_no_loops_on_straight_run():
    cfg = loop_cfg()
    reader = SimulationReader(cfg.data, n_scans=25, radius=200.0, step=1.5,
                              seed=3, device="cpu")
    slam = SurfelSLAM(cfg, device="cpu")
    for i in range(25):
        s = reader.read(i)
        slam.process_scan(s.points, s.labels, s.probs, s.valid)
    assert slam._loop.num_loop_closures == 0
    assert slam._loop.num_optimizations == 0
    slam.finalize()
    assert len(slam.poses) == 25


@pytest.mark.parametrize("loops", [True, False])
def test_finalize_on_a_zero_scan_run(loops):
    slam = SurfelSLAM(loop_cfg(), enable_loop_closure=loops, device="cpu")
    assert slam.finalize() is None
    assert slam.flush() is None
    assert slam.trajectory().shape == (0, 4, 4)


def test_warmup_leaves_the_state_value_identical():
    cfg = loop_cfg()
    reader = SimulationReader(cfg.data, n_scans=6, radius=16.0, step=1.6,
                              seed=2, device="cpu")
    slam = SurfelSLAM(cfg, device="cpu")
    for i in range(6):
        s = reader.read(i)
        slam.process_scan(s.points, s.labels, s.probs, s.valid)
    before = slam.state
    n_valid = int(tsm.sync(before.map, cfg.map).data.valid.sum())
    pose0, poses0 = before.pose.clone(), [p.copy() for p in slam.poses]
    version0 = slam.map_version
    slam._loop.warmup(slam)
    after = tsm.sync(slam.state.map, cfg.map)
    assert int(after.data.valid.sum()) == n_valid == int(after.count)
    np.testing.assert_allclose(slam.state.pose.numpy(), pose0.numpy(),
                               atol=1e-6)
    np.testing.assert_array_equal(np.stack(slam.poses), np.stack(poses0))
    np.testing.assert_allclose(slam.state.map.poses[:6].numpy(),
                               np.stack(poses0), atol=1e-6)
    assert slam.map_version > version0
    assert slam._old_cache._view is None
    assert "loop-warmup" in slam.stopwatch.stats
    # the run goes on
    s = reader.read(5)
    slam.process_scan(s.points, s.labels, s.probs, s.valid)
    assert np.isfinite(slam.trajectory()).all()
