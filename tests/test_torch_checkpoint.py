"""The port's session checkpoints (``utils/checkpoint``) on the CPU, against
themselves and against the JAX package's archives.

* A port run stopped after 32 scans of the forced-spill circle (24x120,
  2^15 rows, loop closure and spill on; its first spill comes near scan 28)
  and resumed from the archive equals the same run without a stop over 4
  more scans: every pose exactly, the loop state (pose graph, candidates,
  counters) equal, the spill chunks' rows equal (their centroids, which
  the loader re-derives from the pose table as JAX's does, within 1e-5 m).
* A checkpoint that JAX's ``save_checkpoint`` wrote with loop closure on and
  candidates in its closer (a verified one appended, as ``LoopCloser``
  appends them) resumes in the port: every state leaf equals
  ``convert.slam_state_from_numpy`` of the archived JAX state, the host and
  loop state equal the JAX session's, and three more scans follow the JAX
  session resumed from the same archive within the per-scan tolerance of
  ``test_odometry_step_matches_jax_per_scan`` (1e-3 m, 1e-3 rad, the same
  Gauss-Newton iterations and map count).
* A port archive with loop closure off loads in JAX's ``load_checkpoint``,
  every leaf in the dtype JAX's template has.
* A capacity mismatch raises the JAX message; the loop blob's unpickler
  refuses a global that is neither a candidate, numpy nor a plain builtin.
"""
import torch_env  # noqa: F401  (first: one torch thread)

import dataclasses
import io
import pickle

import jax
import numpy as np
import pytest
import torch

from semantic_suma_tpu.config import SumaConfig as JConfig
from semantic_suma_tpu.core import loop_closure as jlc
from semantic_suma_tpu.core import pipeline as jp
from semantic_suma_tpu.io import simulation as jsim
from semantic_suma_tpu.utils import checkpoint as jck
from semantic_suma_tpu_torch.config import SumaConfig, forced_spill_config
from semantic_suma_tpu_torch.convert import slam_state_from_numpy
from semantic_suma_tpu_torch.core.loop_closure import LoopClosureCandidate
from semantic_suma_tpu_torch.core.pipeline import SurfelSLAM
from semantic_suma_tpu_torch.io.simulation import SimulationReader, rich_world
from semantic_suma_tpu_torch.utils import checkpoint as tck


def _leaves(state):
    return {k: v.numpy() for k, v in tck._flatten_with_paths(state).items()}


def _loop_state(lc):
    """The loop closer's archived fields, comparable with ``==``."""
    return pickle.loads(pickle.dumps({
        "poses": [np.asarray(p).tolist() for p in lc.posegraph._poses],
        "edges": [(int(i), int(j), np.asarray(z).tolist(),
                   np.asarray(info).tolist(), *rest)
                  for i, j, z, info, *rest in lc.posegraph._edges],
        "cands": [(c.frm, c.to, np.asarray(c.rel_pose).tolist())
                  for c in lc.unverified + [None] + lc.verified
                  if c is not None],
        "n_unverified": len(lc.unverified),
        "flags": (lc.already_verified, lc.time_without_loop, lc.loop_count,
                  lc.num_loop_closures),
        "anchors": [None if a is None else np.asarray(a).tolist()
                    for a in (lc.pose_old, lc.last_pose_old)]}))


N_STOP, N_MORE = 32, 4


def test_stopped_and_resumed_run_equals_unstopped(tmp_path):
    cfg = forced_spill_config(24, 120, 1 << 15, 1 << 13)
    reader = SimulationReader(cfg.data, n_scans=N_STOP + N_MORE,
                              world=rich_world(), radius=16.0, step=1.6,
                              noise_sigma=0.03, seed=2, device="cpu")
    scans = [reader.read(i) for i in range(N_STOP + N_MORE)]
    slam = SurfelSLAM(cfg, device="cpu")
    for s in scans[:N_STOP]:
        slam.process_scan(s.points, s.labels, s.probs, s.valid)
    assert slam.spill.chunks, "no chunk spilled before the stop"
    path = str(tmp_path / "s.npz")
    tck.save_checkpoint(slam, path, compact_map=False)

    resumed = tck.load_checkpoint(path, cfg, device="cpu")
    assert resumed._dispatched == len(resumed.poses) == N_STOP
    for s in scans[N_STOP:]:
        for run in (slam, resumed):
            run.process_scan(s.points, s.labels, s.probs, s.valid)
    np.testing.assert_array_equal(resumed.trajectory(), slam.trajectory())
    assert _loop_state(resumed._loop) == _loop_state(slam._loop)
    assert len(resumed.spill.chunks) == len(slam.spill.chunks)
    for a, b in zip(resumed.spill.chunks, slam.spill.chunks):
        np.testing.assert_array_equal(a.f, b.f)
        np.testing.assert_array_equal(a.i, b.i)
        # the loader re-derives each centroid from the pose table (as JAX's
        # does); the running session kept the one of the cached world rows
        np.testing.assert_allclose(a.centroid, b.centroid, rtol=0,
                                   atol=1e-5)
    assert resumed.spill.chunks_paged_in == slam.spill.chunks_paged_in
    got, want = _leaves(resumed.state), _leaves(slam.state)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def jax_archive(tmp_path_factory):
    """A JAX session (``SumaConfig().small()``, loop closure on) over 5
    scans, with one verified candidate, saved by JAX's
    ``save_checkpoint``; and the scans that come next."""
    jcfg = JConfig().small()
    reader = jsim.SimulationReader(jcfg.data, n_scans=8, radius=18.0)
    slam = jp.SurfelSLAM(jcfg, enable_loop_closure=True)
    for i in range(5):
        s = reader.read(i)
        slam.process_scan(s.points, s.labels, s.probs, s.valid)
    lc = slam._loop
    lc.verified.append(jlc.LoopClosureCandidate(
        frm=4, to=1, rel_pose=np.linalg.inv(slam.poses[4])
        @ lc.posegraph.pose(1)))
    path = str(tmp_path_factory.mktemp("ck") / "jax.npz")
    jck.save_checkpoint(slam, path)
    nxt = [tuple(np.asarray(a) for a in (s.points, s.labels, s.probs,
                                          s.valid))
           for s in (reader.read(i) for i in range(5, 8))]
    return path, slam, nxt


def test_jax_checkpoint_resumes_in_port(jax_archive):
    path, jslam, nxt = jax_archive
    tslam = tck.load_checkpoint(path, SumaConfig().small(), device="cpu")
    jres = jck.load_checkpoint(path, JConfig().small())

    want = _leaves(slam_state_from_numpy(jax.tree.map(np.asarray,
                                                      jres.state), "cpu"))
    got = _leaves(tslam.state)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(tslam.trajectory(),
                                  np.stack(jslam.poses).astype(np.float32))
    assert tslam.statistics == jres.statistics
    assert tslam.trajectory_distances == jres.trajectory_distances
    assert tslam._dispatched == jres._dispatched == 5
    assert all(type(c) is LoopClosureCandidate for c in tslam._loop.verified)
    assert _loop_state(tslam._loop) == _loop_state(jres._loop)

    for pts, lab, prob, valid in nxt:
        jst = jres.process_scan(pts, lab, prob, valid)
        tst = tslam.process_scan(*(torch.tensor(a) for a in
                                   (pts, lab, prob, valid)))
        pj = np.asarray(jres.poses[-1], np.float64)
        pt = np.asarray(tslam.poses[-1], np.float64)
        np.testing.assert_allclose(pt[:3, 3], pj[:3, 3], atol=1e-3)
        rel = np.linalg.inv(pj) @ pt
        skew = np.array([rel[2, 1] - rel[1, 2], rel[0, 2] - rel[2, 0],
                         rel[1, 0] - rel[0, 1]])
        assert float(np.arcsin(min(1.0, np.linalg.norm(skew) / 2))) <= 1e-3
        assert tst["icp-iterations"] == int(jst["icp-iterations"])
        assert tst["map-count"] == int(jst["map-count"])


def test_port_archive_loads_in_jax(tmp_path):
    cfg = SumaConfig().small()
    reader = SimulationReader(cfg.data, n_scans=3, radius=18.0, device="cpu")
    slam = SurfelSLAM(cfg, enable_loop_closure=False, device="cpu")
    for i in range(3):
        s = reader.read(i)
        slam.process_scan(s.points, s.labels, s.probs, s.valid)
    path = str(tmp_path / "port.npz")
    tck.save_checkpoint(slam, path)

    jslam = jck.load_checkpoint(path, JConfig().small(),
                                enable_loop_closure=False)
    data = np.load(path)
    flat, _ = jax.tree_util.tree_flatten_with_path(jp.SurfelSLAM(
        JConfig().small(), enable_loop_closure=False).state)
    for p, leaf in flat:
        key = "/".join(q.name for q in p)
        assert data[key].dtype == leaf.dtype, key
    for k, v in tck._flatten_with_paths(jax.tree.map(np.asarray,
                                                     jslam.state)).items():
        np.testing.assert_array_equal(v, data[k], err_msg=k)
    np.testing.assert_array_equal(np.stack(jslam.poses), slam.trajectory())
    assert bytes(data["__loop__"]) == b""


def test_shape_mismatch_raises_the_jax_message(tmp_path):
    cfg = SumaConfig().small()
    path = str(tmp_path / "c.npz")
    tck.save_checkpoint(SurfelSLAM(cfg, device="cpu"), path)
    small = cfg.replace(map=dataclasses.replace(cfg.map,
                                                surfel_capacity=1 << 15))
    with pytest.raises(ValueError) as port_err:
        tck.load_checkpoint(path, small, device="cpu")
    jcfg = JConfig().small()
    jsmall = jcfg.replace(map=dataclasses.replace(jcfg.map,
                                                  surfel_capacity=1 << 15))
    with pytest.raises(ValueError) as jax_err:
        jck.load_checkpoint(path, jsmall)
    assert str(port_err.value) == str(jax_err.value)
    assert "use the same capacities" in str(port_err.value)


def test_loop_unpickler_refuses_other_globals():
    import os
    blob = pickle.dumps({"x": os.getcwd})
    with pytest.raises(pickle.UnpicklingError, match="posix.getcwd"):
        tck._LoopUnpickler(io.BytesIO(blob)).load()
    ok = pickle.dumps({"a": np.arange(3, dtype=np.float32),
                       "s": np.float32(2.5), "t": {1, 2}})
    got = tck._LoopUnpickler(io.BytesIO(ok)).load()
    np.testing.assert_array_equal(got["a"], np.arange(3, dtype=np.float32))
    assert got["t"] == {1, 2}
