"""The port's sharded pipeline (``parallel/sharding``) against the JAX
package's on its virtual CPU mesh (``tests/conftest.py``), at JAX's
``small_cfg`` (32x128). The port's ranks are gloo processes on the CPU
(``tests/torch_ranks.py``), started with a ``file://`` rendezvous and joined
with a deadline; the two-rank checks run in one start of the ranks beside
one JAX ``make_mesh(2)`` session, shared with
``test_torch_sharded_session.py`` (``tests/torch_shared.py``).

* D = 1 (in the test's process: a group of one, no process group) and
  D = 2 against JAX's ``make_mesh(D)`` over 5 scans, each scan started from
  the JAX session's state (``convert.sharded_state_from_jax``): every pose
  within 1e-3 m and 1e-3 rad of JAX's, the same Gauss-Newton iterations and
  the same map count (the tolerance of
  ``test_torch_pipeline.py::test_odometry_step_matches_jax_per_scan``).
* JAX's invariants: no phantom surfels (each rank's valid rows sum to at
  most the map count, after 6 scans), rebase and compaction, and two ranks
  against the single-device port within JAX's 0.1 m over 6 scans, both
  ranks with the same trajectory.
"""
import torch_env  # noqa: F401  (first: one torch thread)

import dataclasses

import numpy as np
import pytest
import torch

import torch_ranks
from semantic_suma_tpu.io.simulation import SimulationReader as JReader
from semantic_suma_tpu.parallel import sharding as jsh
from semantic_suma_tpu_torch.core.pipeline import SurfelSLAM
from semantic_suma_tpu_torch.parallel.distributed import launch
from torch_shared import (PARITY_SCANS, jax_session, jax_small_cfg,
                          save_scans, two_ranks)  # noqa: F401 (a fixture)

JOIN_S = 60


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    """The first scans of JAX's ``SimulationReader(small, 60, 18 m)``."""
    reader = JReader(jax_small_cfg().data, n_scans=60, radius=18.0)
    return save_scans(reader, PARITY_SCANS,
                      tmp_path_factory.mktemp("scans") / "scans.npz")


def _rot(a, b) -> float:
    rel = np.linalg.inv(a.astype(np.float64)) @ b.astype(np.float64)
    skew = np.array([rel[2, 1] - rel[1, 2], rel[0, 2] - rel[2, 0],
                     rel[1, 0] - rel[0, 1]])
    return float(np.arcsin(min(1.0, np.linalg.norm(skew) / 2)))


@pytest.mark.parametrize("d", [1, 2])
def test_sharded_matches_jax_per_scan(d, request, tmp_path):
    if d == 1:
        scans = request.getfixturevalue("scans")
        forced = tmp_path / "forced1.npz"
        rows, _ = jax_session(scans, 1, PARITY_SCANS, forced)
        got = [torch_ranks.drive(0, torch.device("cpu"),
                                 torch_ranks.small_cfg(), scans,
                                 PARITY_SCANS, False, str(forced))]
    else:
        suite = request.getfixturevalue("two_ranks")
        rows = suite["jax_rows"][:PARITY_SCANS]
        got = [r["parity"] for r in suite["ranks"]]
    for r in range(d):
        for i, (pose, count, iters) in enumerate(rows):
            pt = got[r]["poses"][i]
            np.testing.assert_allclose(pt[:3, 3], pose[:3, 3], atol=1e-3,
                                       err_msg=f"rank {r} scan {i}")
            assert _rot(pose, pt) <= 1e-3, (r, i)
            assert got[r]["iterations"][i] == iters, (r, i)
            assert got[r]["counts"][i] == count, (r, i)


def test_sharded_no_phantom_surfels(two_ranks):
    """JAX's ``test_sharded_no_phantom_surfels``: the ranks' valid rows,
    written back, sum to at most the map count."""
    out = [r["free"] for r in two_ranks["ranks"]]
    total = sum(o["valid_rows"] for o in out)
    assert 0 < total <= out[0]["map_count"], (total, out[0]["map_count"])


def test_sharded_rebase_and_compact(two_ranks):
    for o in (r["rebase"] for r in two_ranks["ranks"]):
        np.testing.assert_allclose(o["pose0"], o["want0"])
        assert o["version"] == 1
        assert o["after"] >= o["before"]
        # compaction keeps exactly the valid rows of the shard
        assert o["count_after_compact"] == o["valid_before_compact"]
        assert o["after_compact"] >= o["after"]


def test_two_ranks_match_single_device_port(two_ranks):
    """JAX's ``test_sharded_matches_single_device`` in the port: 6 scans on
    two ranks against ``SurfelSLAM`` on the CPU, within JAX's 0.1 m."""
    out = [r["free"] for r in two_ranks["ranks"]]
    n = len(out[0]["poses"])
    z = np.load(two_ranks["scans"])
    slam = SurfelSLAM(torch_ranks.small_cfg(), enable_loop_closure=False,
                      device="cpu")
    for i in range(n):
        slam.process_scan(z[f"p{i}"], z[f"l{i}"], z[f"q{i}"], z[f"v{i}"])
    err = np.linalg.norm(out[0]["poses"][-1][:3, 3]
                         - slam.trajectory()[-1][:3, 3])
    assert err < 0.1, err
    np.testing.assert_array_equal(np.stack(out[1]["poses"]),
                                  np.stack(out[0]["poses"]))
    assert out[0]["map_count"] > 500 and out[0]["creations_dropped"] == 0


def test_config_division():
    from semantic_suma_tpu_torch.parallel.sharding import shard_map_config
    jm = jsh.shard_map_config(jax_small_cfg(), 2)
    tm = shard_map_config(torch_ranks.small_cfg(), 2)
    for f in ("surfel_capacity", "active_capacity", "min_fresh_rows"):
        assert getattr(tm, f) == getattr(jm, f), f
    assert dataclasses.is_dataclass(tm)


def test_rank_failure_and_timeout_raise(tmp_path):
    """A rank that raises fails the launch; ranks that outlive the deadline
    are killed and the launch raises."""
    with pytest.raises(Exception, match="boom"):
        launch(torch_ranks.fail_on_rank, 2, (1, "boom"), cpu=True,
               threads=1, join_timeout_s=JOIN_S)
    with pytest.raises(TimeoutError):
        launch(torch_ranks.sleep, 2, (30.0,), cpu=True, threads=1,
               join_timeout_s=3)
