"""Chunked dispatch of the port (``odometry_run``, ``odometry_chunk_fetch``,
``SurfelSLAM(chunk_size=K)``) against the JAX package and against the
port's own per-step ``SurfelSLAM``, at ``small()`` (32x180, loop closure
off) on scans of the JAX simulator (the 18 m circle at 1.5 m steps; each
scan's confidence threshold from ``SurfelSLAM``'s warmup schedule).

* ``odometry_run`` over 4 scans: every pose within 1e-6 m of the port's
  per-step ``odometry_step`` and the map counts exact; against JAX's
  ``odometry_run`` within the per-scan tolerance of
  ``test_odometry_step_matches_jax_per_scan`` (1e-3 m, 1e-3 rad) and the
  same Gauss-Newton iterations. Both packages run freely here (that test
  starts each scan from JAX's state), so the map counts are held to the
  free-run rule of ``test_free_run_map_count_within_half_percent``, 0.5%:
  a surfel-level difference of fusion (1 to 4 surfels of ~10^4 over these
  scans) is no fault of the batch.
* ``process_scan_async`` with ``chunk_size`` 1 and 4 (depth 3, spill on)
  over 14 scans equals the synchronous ``process_scan``: poses within 1e-5 m and every
  scan's ``map-count`` exact (JAX's ``test_async_chunked_matches_sync``).
* A chunk of scans with unequal point counts, stacked with pad rows, equals
  the per-step run of the unpadded scans (JAX's
  ``test_variable_size_scans_bucketed``), within 1e-6 m, map counts exact.
* ``SurfelSLAM.syncs`` counts the host reads of every step of a chunk and
  one fetch a chunk.
"""
import torch_env  # noqa: F401  (first: one torch thread)

import numpy as np
import pytest
import torch

import torch_shared
from semantic_suma_tpu.config import LoopClosureConfig as JLoop
from semantic_suma_tpu.config import MapConfig as JMap
from semantic_suma_tpu.config import SumaConfig as JConfig
from semantic_suma_tpu_torch.config import (LoopClosureConfig, MapConfig,
                                            SumaConfig)
from semantic_suma_tpu_torch.core import pipeline as tp
from semantic_suma_tpu_torch.utils.checkpoint import save_checkpoint

N_SCANS = 14
RUN_SCANS = 4


def _cfg(spill: bool = True):
    return SumaConfig(map=MapConfig(spill_enabled=spill),
                      loop=LoopClosureConfig(enabled=False)).small()


def _jax_part(_):
    """The JAX simulator's scans and JAX's ``odometry_run`` over the first
    ``RUN_SCANS`` of them."""
    import jax.numpy as jnp

    from semantic_suma_tpu.core import pipeline as jp
    from semantic_suma_tpu.io.simulation import SimulationReader
    jcfg = JConfig(map=JMap(spill_enabled=False),
                   loop=JLoop(enabled=False)).small()
    reader = SimulationReader(jcfg.data, n_scans=60, radius=18.0,
                              step=1.5)
    scans = [tuple(np.asarray(a) for a in (s.points, s.labels, s.probs,
                                           s.valid))
             for s in (reader.read(i) for i in range(N_SCANS))]
    stk = [jnp.stack([s[k] for s in scans[:RUN_SCANS]]) for k in range(4)]
    _, infos = jp.odometry_run(jp.init_state(jcfg), *stk,
                                jnp.asarray(_confs(), jnp.float32), jcfg)
    return {"scans": scans, "poses": np.asarray(infos.pose),
            "iterations": np.asarray(infos.iterations),
            "map_counts": np.asarray(infos.map_count)}


def _confs(n: int = RUN_SCANS):
    """``SurfelSLAM``'s confidence warmup schedule (``HostLoop._conf_at``)
    for the first ``n`` scans."""
    return [tp.SurfelSLAM(_cfg(spill=False), device="cpu")._conf_at(i)
            for i in range(n)]


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    return torch_shared.once(tmp_path_factory, "chunked-jax", _jax_part)


def _t(scan):
    return tuple(torch.from_numpy(a) for a in scan)


def _rot_angle(a, b) -> float:
    rel = np.linalg.inv(a.astype(np.float64)) @ b.astype(np.float64)
    skew = np.array([rel[2, 1] - rel[1, 2], rel[0, 2] - rel[2, 0],
                     rel[1, 0] - rel[0, 1]])
    return float(np.arcsin(min(1.0, np.linalg.norm(skew) / 2)))


def test_odometry_run_matches_jax_and_per_step(jax_run):
    cfg = _cfg(spill=False)
    scans = [_t(s) for s in jax_run["scans"][:RUN_SCANS]]
    st = tp.init_state(cfg, "cpu")
    step_poses, step_counts = [], []
    for s, ct in zip(scans, _confs()):
        st, info = tp.odometry_step(st, *s, ct, cfg)
        step_poses.append(info.pose.numpy())
        step_counts.append(int(info.map_count))

    stacked = [torch.stack([s[k] for s in scans]) for k in range(4)]
    run_st, infos = tp.odometry_run(tp.init_state(cfg, "cpu"), *stacked,
                                    torch.tensor(_confs()), cfg)
    poses = infos.pose.numpy()
    assert poses.shape == (RUN_SCANS, 4, 4)
    assert infos.iterations.shape == (RUN_SCANS,)
    assert infos.stats.error.shape == (RUN_SCANS,)
    np.testing.assert_allclose(poses, np.stack(step_poses), atol=1e-6)
    assert infos.map_count.tolist() == step_counts
    assert int(run_st.map.count) == int(st.map.count)

    for i in range(RUN_SCANS):
        pj = jax_run["poses"][i]
        np.testing.assert_allclose(poses[i][:3, 3], pj[:3, 3], atol=1e-3,
                                   err_msg=f"scan {i}")
        assert _rot_angle(pj, poses[i]) <= 1e-3, i
    assert infos.iterations.tolist() == jax_run["iterations"].tolist()
    counts = infos.map_count.numpy()
    assert (np.abs(counts - jax_run["map_counts"])
            <= 0.005 * jax_run["map_counts"]).all(), counts


def test_chunk_fetch_packs_each_step(jax_run):
    cfg = _cfg(spill=False)
    scans = [_t(s) for s in jax_run["scans"][:RUN_SCANS]]
    st = tp.init_state(cfg, "cpu")
    rows = []
    for s, ct in zip(scans, _confs()):
        st, packed = tp.odometry_step_fetch(st, *s, ct, cfg)
        rows.append(packed.numpy())
    stacked = [torch.stack([s[k] for s in scans]) for k in range(4)]
    st2, infos = tp.odometry_chunk_fetch(tp.init_state(cfg, "cpu"), *stacked,
                                         _confs(), cfg)
    assert infos.shape == (RUN_SCANS, 50) and infos.dtype == torch.float32
    np.testing.assert_array_equal(infos.numpy(), np.stack(rows))
    assert int(st2.map.count) == int(st.map.count)


def _drive_async(cfg, scans, chunk, depth=3):
    slam = tp.SurfelSLAM(cfg, pipeline_depth=depth, chunk_size=chunk,
                         device="cpu")
    for s in scans:
        slam.process_scan_async(*s)
    slam.flush()
    return slam


def test_async_chunked_matches_sync(jax_run):
    cfg = _cfg()
    scans = [_t(s) for s in jax_run["scans"]]
    sync = tp.SurfelSLAM(cfg, device="cpu")
    for s in scans:
        sync.process_scan(*s)
    for chunk in (1, 4):
        slam = _drive_async(cfg, scans, chunk)
        assert len(slam.poses) == N_SCANS and not slam._inflight()
        np.testing.assert_allclose(np.stack(slam.poses),
                                   np.stack(sync.poses), atol=1e-5)
        assert [st["map-count"] for st in slam.statistics] == \
            [st["map-count"] for st in sync.statistics]
        # one fetch a dispatch: 3 chunks of 4 and the last 2 scans one by
        # one (a partial chunk goes out scan by scan)
        fetches = N_SCANS if chunk == 1 else 3 + 2
        assert slam.syncs == sync.syncs - N_SCANS + fetches, chunk


def test_chunk_of_unequal_scans_matches_unpadded_steps(jax_run):
    cfg = _cfg()
    per_step = tp.SurfelSLAM(cfg, device="cpu")
    chunked = tp.SurfelSLAM(cfg, chunk_size=4, device="cpu")
    sizes = []
    for i, s in enumerate(jax_run["scans"][:8]):
        # drop a different number of trailing points from each scan
        n = s[0].shape[0] - 17 * (i + 1)
        sizes.append(n)
        cut = _t(tuple(a[:n] for a in s))
        per_step.process_scan(*cut)
        chunked.process_scan_async(*cut)
    chunked.flush()
    assert len(set(sizes)) == 8
    np.testing.assert_allclose(np.stack(chunked.poses),
                               np.stack(per_step.poses), atol=1e-6)
    assert [st["map-count"] for st in chunked.statistics] == \
        [st["map-count"] for st in per_step.statistics]


def test_pad_rows_are_invalid_and_stack_to_the_largest_scan():
    a = (torch.ones(3, 3), torch.full((3,), 7, dtype=torch.int32),
         torch.full((3,), 0.5), torch.ones(3, dtype=torch.bool))
    b = tuple(x[:2] for x in a)
    pts, lab, prb, val = tp._stack_padded([a, b], 3)
    assert pts.shape == (2, 3, 3) and lab.dtype == torch.int32
    assert val.dtype == torch.bool
    assert pts[1, 2].eq(0).all() and lab[1, 2] == 0 and prb[1, 2] == 0
    assert val[1].tolist() == [True, True, False]
    assert torch.equal(pts[0], a[0]) and torch.equal(val[0], a[3])
    padded = tp._pad_inputs(*b, 5)
    assert [x.shape[0] for x in padded] == [5] * 4
    assert padded[3].sum() == 2


def test_buffered_scans_count_as_in_flight(jax_run, tmp_path):
    cfg = _cfg()
    slam = tp.SurfelSLAM(cfg, pipeline_depth=0, chunk_size=4, device="cpu")
    scans = [_t(s) for s in jax_run["scans"][:5]]
    for s in scans[:3]:
        assert slam.process_scan_async(*s) is None
    # three scans buffered, none dispatched: each took its confidence
    # threshold at its place in the sequence
    assert slam._inflight() == 3 and not slam._pending
    assert [e[4] for e in slam._chunk_buf] == [slam._conf_at(i)
                                               for i in range(3)]
    with pytest.raises(ValueError, match="in flight"):
        save_checkpoint(slam, str(tmp_path / "s.npz"))
    # the fourth fills the chunk; depth 0 drains it at once, all four scans
    out = slam.process_scan_async(*scans[3])
    assert out is not None and len(slam.poses) == 4
    assert slam._inflight() == 0
    slam.process_scan_async(*scans[4])
    assert slam.flush() is not None and len(slam.poses) == 5
