"""Sessions of the port's sharded pipeline on two gloo ranks on the CPU
(``tests/torch_ranks.py``): loop closure, data-parallel training and the
sharded checkpoints, against the JAX package where it has the same thing.
All but the loop closure read the two-rank suite and the JAX
``make_mesh(2)`` session shared with ``test_torch_sharding.py``
(``tests/torch_shared.py``), on the scans of JAX's
``SimulationReader(small, 60, 18 m)``.

* JAX's ``test_sharded_loop_closure`` (24x120, 75 noisy scans around a
  16 m circle): at least one closure and one optimization on every rank,
  the ranks' trajectories equal, the last pose within JAX's 1 m.
* One f32 data-parallel step of ``small_rangenet``, 2 ranks of batch 2,
  against the port's single-device step of batch 4: the loss within 1e-6
  relative, the batch statistics within 1e-6 and every gradient leaf
  within 1e-4 of its scale, with the ``leaky_relu`` kink rule of
  ``tests/test_torch_train.py``: the
  gradient jumps 10x at the kink, and the two computations (which differ
  in the order of the batch-norm sums) put a few of the ~10^6 inputs that
  lie within float32 rounding of it on different sides, which moves the
  leaves behind them by up to 5% of their scale; so the ranks take each
  input's side from the single-device forward, and at most 4 inputs a rank
  may change side, each within 1e-4 of the kink.
* Checkpoints: a port session stopped at scan 6, saved and resumed equals
  the run without a stop (the stop within 1e-6, the 12th pose within 1e-3 m,
  the map count exact, as JAX's own test); an archive of JAX's
  ``make_mesh(2)`` session resumes in 2 port ranks that never import JAX
  (each rank's map count exact), and its two free scans stay within 1e-3 m
  of JAX's, the map count within 0.5%; the port's archive of
  that continuation loads in JAX's ``load_checkpoint_sharded`` with every
  shard leaf equal; a mesh of another size refuses an archive with JAX's
  message.
"""
import torch_env  # noqa: F401  (first: one torch thread)

import jax
import numpy as np
import pytest

import torch_ranks
from semantic_suma_tpu.config import DataConfig as JData
from semantic_suma_tpu.io.simulation import SimulationReader as JReader
from semantic_suma_tpu.parallel import sharding as jsh
from semantic_suma_tpu.utils import checkpoint as jckpt
from semantic_suma_tpu_torch.parallel.distributed import launch
from torch_shared import (JAX_SCANS, STOP, jax_small_cfg, save_scans,
                          two_ranks)  # noqa: F401 (a fixture)

JOIN_S = 80


def test_sharded_loop_closure(tmp_path):
    cfg = torch_ranks.loop_cfg()
    n = 75
    reader = JReader(JData(width=120, height=24), n_scans=n, radius=16.0,
                     step=1.6, noise_sigma=0.03, seed=2)
    scans = save_scans(reader, n, tmp_path / "loop.npz")
    out = launch(torch_ranks.drive, 2, (cfg, scans, n, True), cpu=True,
                 threads=1, timeout_s=JOIN_S, join_timeout_s=JOIN_S)
    for o in out:
        assert o["closures"] >= 1, o["closures"]
        assert o["optimizations"] >= 1
        assert o["creations_dropped"] == 0
    np.testing.assert_array_equal(np.stack(out[1]["poses"]),
                                  np.stack(out[0]["poses"]))
    gt = np.asarray(reader.poses)
    rel_gt = np.linalg.inv(gt[0]) @ gt[n - 1]
    err = np.linalg.norm(out[0]["poses"][n - 1][:3, 3] - rel_gt[:3, 3])
    assert err < 1.0, err


def _close_to_scale(got, want, tol):
    assert got.keys() == want.keys()
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol * scale,
                                   err_msg=k)


def test_data_parallel_step_matches_single_device(two_ranks):
    single = two_ranks["single_step"]
    for o in (r["train"] for r in two_ranks["ranks"]):
        # the inputs the ranks' own forward would put on the other side
        assert o["moved"].size <= 4 and (o["moved"] < 1e-4).all(), \
            o["moved"]
        np.testing.assert_allclose(o["loss"], single["loss"], rtol=1e-6)
        np.testing.assert_allclose(o["accuracy"], single["accuracy"],
                                   rtol=1e-6)
        _close_to_scale(o["buffers"], single["buffers"], 1e-6)
        _close_to_scale(o["grads"], single["grads"], 1e-4)


def test_port_session_stop_and_resume(two_ranks):
    for o in (r["checkpoint"] for r in two_ranks["ranks"]):
        assert o["resumed_at"] == STOP
        np.testing.assert_allclose(o["resumed_last"], o["ref"][STOP - 1],
                                   atol=1e-6)
        np.testing.assert_allclose(o["got"][-1], o["ref"][-1], atol=1e-3)
        assert o["got_count"] == o["ref_count"]


def test_archives_cross_between_packages(two_ranks):
    out = [r["resume"] for r in two_ranks["ranks"]]
    jrows = two_ranks["jax_rows"]
    zj = np.load(two_ranks["jax_ckpt"])
    for r, o in enumerate(out):
        assert o["resumed_at"] == STOP and not o["jax_loaded"]
        assert o["local_count"] == int(zj[f"shard{r}/count"])
        for i in range(STOP, JAX_SCANS):
            np.testing.assert_allclose(o["poses"][i][:3, 3],
                                       jrows[i][0][:3, 3], atol=1e-3)
    # two free scans from the same state: the map counts within the 0.5% of
    # test_torch_pipeline.py's free run
    want = two_ranks["jax_count"]
    assert abs(out[0]["map_count"] - want) <= 0.005 * want

    ppath = two_ranks["port_ckpt"]
    back = jckpt.load_checkpoint_sharded(ppath, jax_small_cfg(),
                                         jsh.make_mesh(2),
                                         enable_loop_closure=False)
    assert len(back.poses) == JAX_SCANS
    np.testing.assert_array_equal(np.stack(back.poses),
                                  np.stack(out[0]["poses"]))
    z = np.load(ppath)
    for d in range(2):
        shard = jax.tree.map(np.asarray, back._local_shard(d))
        np.testing.assert_array_equal(shard.data.f, z[f"shard{d}/data/f"])
        np.testing.assert_array_equal(shard.active_blocks,
                                      z[f"shard{d}/active_blocks"])
        assert int(shard.count) == int(z[f"shard{d}/count"])
    assert sum(int(z[f"shard{d}/count"]) for d in range(2)) == \
        out[0]["map_count"]
    # a mesh of another size refuses the archive with JAX's message
    from semantic_suma_tpu_torch.parallel.sharding import make_mesh
    from semantic_suma_tpu_torch.utils.checkpoint import \
        load_checkpoint_sharded
    with pytest.raises(ValueError, match="checkpoint has 2 shards, mesh has 1"):
        load_checkpoint_sharded(two_ranks["jax_ckpt"],
                                torch_ranks.small_cfg(),
                                make_mesh(device="cpu"))
