"""The port's odometry step reads the host once, for its branch flags (its
Gauss-Newton loops read nothing), and still takes JAX's branches.

Four kinds of steps start from one mid-run JAX state (``SumaConfig().small()``,
scans of the JAX simulator), each converted with
``convert.slam_state_from_numpy`` and stepped by both packages:

* ``plain``: the anchor at the vehicle (no refresh, no fallback, nothing
  dropped);
* ``refresh``: the anchor unset, so the view refreshes;
* ``fallback``: a wild ``last_increment`` (0.6 m off, over the 0.4 m jump),
  so the track-loss fallback runs;
* ``overflow``: the arena exhausted (``block_count`` at the arena's blocks)
  and the append cursor 64 rows before the end of the view, so this scan's
  creations do not fit and are dropped.

Each step against JAX's ``odometry_step``: the pose within 1e-3 m and 1e-3
rad (``test_odometry_step_matches_jax_per_scan``'s limits), the iterations,
``track_loss``, ``n_created``, ``n_dropped``, ``map_count``,
``active_count`` and ``active_blocks`` exactly. Its host reads
(``StepInfo.syncs``, every ``to_host`` of the step) are exactly 1, 2 where
the fallback runs.

The masked block write under the refresh and ``sync`` (``_put_rows``) is
held to boolean-mask indexing, and the flag read (``read_flags``) to one
read that returns ``lie.orthonormalize`` of the pose to the bit.
"""
import torch_env  # noqa: F401  (first: one torch thread)

import jax
import numpy as np
import pytest
import torch

import torch_shared
from semantic_suma_tpu.config import (LoopClosureConfig as JLoop,
                                      MapConfig as JMap, SumaConfig as JConfig)
from semantic_suma_tpu.core import pipeline as jp
from semantic_suma_tpu.core import surfel_map as jsm
from semantic_suma_tpu.io import simulation as jsim
from semantic_suma_tpu_torch.config import (LoopClosureConfig, MapConfig,
                                            SumaConfig)
from semantic_suma_tpu_torch.convert import slam_state_from_numpy
from semantic_suma_tpu_torch.core import pipeline as tp
from semantic_suma_tpu_torch.core import surfel_map as tsm
from semantic_suma_tpu_torch.device import to_host
from semantic_suma_tpu_torch.utils import lie as tlie

BASE = 5          # JAX steps before the state the four kinds start from
KINDS = ("plain", "refresh", "fallback", "overflow")
WILD_M = 0.6      # the fallback kind's offset of last_increment


def _configs():
    jcfg = JConfig(map=JMap(spill_enabled=False),
                   loop=JLoop(enabled=False)).small()
    cfg = SumaConfig(map=MapConfig(spill_enabled=False),
                     loop=LoopClosureConfig(enabled=False)).small()
    return jcfg, cfg


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _variant(state, kind, jcfg):
    """The numpy JAX state of one kind of step."""
    m = state.map
    pos = np.asarray(state.pose)[:3, 3].astype(np.float32)
    if kind == "refresh":
        return state._replace(map=m._replace(
            anchor=np.full(3, np.inf, np.float32)))
    if kind == "fallback":
        inc = np.array(state.last_increment)
        inc[0, 3] += WILD_M
        return state._replace(last_increment=inc)
    if kind == "overflow":
        bs, nb, k, _ = jsm._geometry(jcfg.map)
        return state._replace(map=m._replace(
            anchor=pos, block_count=np.asarray(nb, np.int32),
            active_count=np.asarray(k * bs - 64, np.int32)))
    return state._replace(map=m._replace(anchor=pos))


def _compute(_):
    jcfg, cfg = _configs()
    world = jsim.default_world(0, extent=45.0)
    gt = jsim.circular_trajectory(BASE + 1, radius=18.0, step=1.5)
    step = jax.jit(jp.odometry_step, static_argnames=("cfg",))
    js = jp.init_state(jcfg)
    for i in range(BASE):
        ct = (1.0 - i / jcfg.map.time_init) * jcfg.map.log_unstable
        s = jsim.render_scan(world, gt[i], jcfg.data)
        js, _ = step(js, s.points, s.labels, s.probs, s.valid, ct, jcfg)
    base = _numpy(js)
    ct = (1.0 - BASE / jcfg.map.time_init) * jcfg.map.log_unstable
    s = jsim.render_scan(world, gt[BASE], jcfg.data)
    inputs = [torch.from_numpy(np.array(a))
              for a in (s.points, s.labels, s.probs, s.valid)]
    out = {}
    for kind in KINDS:
        start = _variant(base, kind, jcfg)
        j2, ji = step(start, s.points, s.labels, s.probs, s.valid, ct, jcfg)
        state = slam_state_from_numpy(start, "cpu")
        anchor0 = state.map.anchor.clone()
        t2, ti = tp.odometry_step(state, *inputs, ct, cfg)
        out[kind] = {
            "jax": {"pose": np.asarray(ji.pose),
                    "iterations": int(ji.iterations),
                    "track_loss": bool(ji.track_loss),
                    "n_created": int(ji.n_created),
                    "n_dropped": int(ji.n_dropped),
                    "map_count": int(ji.map_count),
                    "active_count": int(j2.map.active_count),
                    "active_blocks": np.asarray(j2.map.active_blocks),
                    "refreshed": not np.array_equal(
                        np.asarray(j2.map.anchor), start.map.anchor)},
            "port": {"pose": ti.pose.numpy(),
                     "iterations": int(ti.iterations),
                     "track_loss": ti.track_loss,
                     "n_created": int(ti.n_created),
                     "n_dropped": int(ti.n_dropped),
                     "map_count": int(ti.map_count),
                     "active_count": int(t2.map.active_count),
                     "active_blocks": t2.map.active_blocks.numpy(),
                     "refreshed": not torch.equal(t2.map.anchor, anchor0)},
            "syncs": ti.syncs,
        }
    return out


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    return torch_shared.once(tmp_path_factory, "host-reads-steps", _compute)


@pytest.mark.parametrize("kind", KINDS)
def test_step_kind_matches_jax_with_one_flag_read(steps, kind):
    r = steps[kind]
    j, t = r["jax"], r["port"]
    # the step is of the kind it is named for, in both packages
    assert j["refreshed"] == t["refreshed"] == (kind == "refresh"), kind
    assert j["track_loss"] == t["track_loss"] == (kind == "fallback"), kind
    assert (j["n_dropped"] > 0) == (kind == "overflow"), j["n_dropped"]

    pj = j["pose"].astype(np.float64)
    pt = t["pose"].astype(np.float64)
    np.testing.assert_allclose(pt[:3, 3], pj[:3, 3], atol=1e-3)
    rel = np.linalg.inv(pj) @ pt
    skew = np.array([rel[2, 1] - rel[1, 2], rel[0, 2] - rel[2, 0],
                     rel[1, 0] - rel[0, 1]])
    assert float(np.arcsin(min(1.0, np.linalg.norm(skew) / 2))) <= 1e-3
    for name in ("iterations", "n_created", "n_dropped", "map_count",
                 "active_count"):
        assert t[name] == j[name], (name, t[name], j[name])
    np.testing.assert_array_equal(t["active_blocks"], j["active_blocks"])

    # the step's host reads: the one flag read, and on a fallback scan the
    # refresh flag at the recovered pose; the Gauss-Newton loops read none
    assert r["syncs"] == (2 if kind == "fallback" else 1), r["syncs"]


def test_put_rows_writes_only_live_rows():
    """``_put_rows`` against boolean-mask indexing: the live rows land, every
    other row keeps its value, whichever entries are live (none, the first,
    a later one, ids past the end or repeated among the masked ones)."""
    rng = np.random.default_rng(0)
    ids = torch.tensor([3, 9, 0, 12, 12, 5])
    rows = torch.from_numpy(rng.normal(size=(6, 4, 2)).astype(np.float32))
    for live in ([0, 0, 0, 0, 0, 0], [1, 0, 0, 0, 0, 0], [0, 0, 1, 0, 0, 1],
                 [1, 1, 1, 0, 0, 1]):
        live = torch.tensor(live, dtype=torch.bool)
        dst = torch.from_numpy(rng.normal(size=(10, 4, 2)).astype(np.float32))
        want = dst.clone()
        want[ids[live]] = rows[live]
        tsm._put_rows(dst, ids, rows, live)
        assert torch.equal(dst, want), live
    # a 1-D target with a where that runs no read
    dst = torch.zeros(10, dtype=torch.bool)
    reads = to_host.count
    tsm._put_rows(dst, torch.tensor([2, 11, 7]),
                  torch.ones(3, dtype=torch.bool),
                  torch.tensor([True, False, True]))
    assert to_host.count == reads
    assert dst.nonzero().flatten().tolist() == [2, 7]


def test_read_flags_is_one_read_with_the_svd_projection():
    """``read_flags``: the two flags and the new pose in one host read; the
    pose is ``lie.orthonormalize`` of the moved pose to the bit (its
    rotation projected by the SVD on the host, its translation kept)."""
    rng = np.random.default_rng(1)
    moved = tlie.se3_exp(torch.from_numpy(rng.normal(size=(2, 6))
                                          .astype(np.float32)))
    moved = moved[0] @ moved[1]
    moved[:3, :3] += 1e-4 * torch.from_numpy(
        rng.normal(size=(3, 3)).astype(np.float32))
    for jump, need in ((None, True), (True, False), (False, True)):
        reads = to_host.count
        jumped, refresh, pose = tp.read_flags(
            None if jump is None else torch.tensor(jump), torch.tensor(need),
            moved)
        assert to_host.count == reads + 1
        assert (jumped, refresh) == (bool(jump), need)
        assert torch.equal(pose, tlie.orthonormalize(moved))
