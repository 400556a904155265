"""The sharded Gauss-Newton route (``ops/icp.py``: ``gauss_newton(...,
group=)``, kernels D and E on one state with the partial sums added over the
ranks) and ``evaluate`` (kernel F's first iteration) against the JAX package
on the CPU, where the wrappers run their plain versions.

Inputs: ``test_torch_gn_loop.py``'s two scans of the JAX simulator at
``SumaConfig().small()`` (32x180), preprocessed by JAX.

* Two gloo ranks on the CPU (``tests/torch_ranks.py``, one start for every
  case), each with 16 of the 32 data rows, against JAX's ``gauss_newton(...,
  axis=)`` under ``shard_map`` on a 2-device mesh (``tests/conftest.py``):
  the pose within 1e-5 m and 1e-5 rad, the iterations equal, the four
  counts exact, the error and the inlier residual within 1e-5 relative
  (the two ranks' row sums are added once, in float32, in both packages);
  the two ranks' poses and statistics equal to the bit (the lockstep: every
  rank runs the update on the same reduced sums); one host read an
  iteration.
* A group of one rank with no process group: the route equals the
  single-device ``gauss_newton`` (kernel F's plain latch) to the bit.
* ``evaluate`` against JAX's ``evaluate`` for nearest and bilinear sampling,
  huber and turkey weights: the counts exact, the error and the inlier
  residual within 1e-5 relative (the port sums the rows' float32 terms in
  another order), device tensors, no host read.
"""
import torch_env  # noqa: F401  (first: one torch thread)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_ranks
from semantic_suma_tpu.config import SumaConfig as JConfig
from semantic_suma_tpu.ops import icp as jicp
from semantic_suma_tpu.parallel import sharding as jsh
from semantic_suma_tpu_torch.config import SumaConfig
from semantic_suma_tpu_torch.device import to_host
from semantic_suma_tpu_torch.ops import icp as ticp
from semantic_suma_tpu_torch.parallel.distributed import Group, launch
from test_torch_gn_loop import CASES, _port, maps  # noqa: F401 (a fixture)

# the cases of the two-rank check: (model transform, data transform,
# max_iterations, IcpConfig fields) of test_torch_gn_loop.CASES
RANK_CASES = ["stops-early", "capped-at-1", "capped-at-3", "solve-fails"]


def _case_maps(maps, case):
    model_f, data_f, cap, kw = CASES[case]
    model, data, inc = maps
    return model_f(model), data_f(data), inc, cap, kw


def _jax_sharded(data, model, inc, cap, kw):
    """JAX's ``gauss_newton(..., axis="map")`` under ``shard_map`` on a
    2-device mesh, the data rows split over the devices."""
    jc = JConfig().small()
    icp_cfg = dataclasses.replace(jc.icp, **kw)

    def go(d, m, t0):
        return jicp.gauss_newton(d, m, t0, icp_cfg, jc.model,
                                 max_iterations=cap, axis="map")
    fn = jax.jit(jsh.shard_map(go, mesh=jsh.make_mesh(2),
                               in_specs=(P("map"), P(), P()), out_specs=P(),
                               check_vma=False))
    return fn(data, model, jnp.asarray(inc))


@pytest.fixture(scope="module")
def two_rank_runs(maps, tmp_path_factory):
    """Every case of ``RANK_CASES`` on two gloo ranks (one start), beside
    JAX's sharded run: ``({case: [rank 0's, rank 1's]}, {case: JAX's})``."""
    arrays, jax_out = {}, {}
    for case in RANK_CASES:
        model, data, inc, cap, kw = _case_maps(maps, case)
        for which, m in (("data", data), ("model", model)):
            for f, a in zip(m._fields, m):
                arrays[f"{case}/{which}/{f}"] = np.asarray(a)
        arrays["inc"] = inc
        jax_out[case] = _jax_sharded(data, model, inc, cap, kw)
    path = tmp_path_factory.mktemp("sharded-gn") / "maps.npz"
    np.savez(path, **arrays)
    cases = {c: (CASES[c][2], CASES[c][3]) for c in RANK_CASES}
    ranks = launch(torch_ranks.sharded_gauss_newton, 2, (str(path), cases),
                   cpu=True, threads=1, timeout_s=60, join_timeout_s=120)
    return {c: [r[c] for r in ranks] for c in RANK_CASES}, jax_out


def _angle(a, b) -> float:
    rel = np.linalg.inv(a.astype(np.float64)) @ b.astype(np.float64)
    skew = np.array([rel[2, 1] - rel[1, 2], rel[0, 2] - rel[2, 0],
                     rel[1, 0] - rel[0, 1]])
    return float(np.arcsin(min(1.0, np.linalg.norm(skew) / 2)))


@pytest.mark.parametrize("case", RANK_CASES)
def test_two_ranks_match_jax_shard_map(two_rank_runs, case):
    ranks, jax_out = two_rank_runs
    rj = jax_out[case]
    want_pose = np.asarray(rj.pose)
    k = int(rj.iterations)
    for r, got in enumerate(ranks[case]):
        np.testing.assert_allclose(got["pose"][:3, 3], want_pose[:3, 3],
                                   atol=1e-5, err_msg=f"rank {r}")
        assert _angle(want_pose, got["pose"]) <= 1e-5, r
        assert got["iterations"] == k, (r, got["iterations"], k)
        assert got["reads"] == k, (r, got["reads"], k)
        for name in ("valid", "inlier", "outlier", "invalid"):
            assert got["stats"][name] == int(getattr(rj.stats, name)), \
                (r, name)
        for name in ("error", "inlier_residual"):
            np.testing.assert_allclose(got["stats"][name],
                                       float(getattr(rj.stats, name)),
                                       rtol=1e-5, err_msg=f"rank {r} {name}")
    a, b = ranks[case]
    assert a["bits"].tobytes() == b["bits"].tobytes()
    cap = CASES[case][2]
    if cap is not None:
        assert k == cap
    elif case == "solve-fails":  # a NaN step: the pose kept, one iteration
        assert k == 1
        np.testing.assert_array_equal(a["pose"], want_pose)
    else:
        assert 1 < k < JConfig().small().icp.max_iterations


@pytest.mark.parametrize("case", list(CASES))
def test_one_rank_equals_the_single_device_loop(maps, case):
    """With no process group the sums over the ranks are the rank's own:
    the route is the single-device loop (here the plain versions of D and E
    on the latch) to the bit, with one host read an iteration."""
    model, data, inc, cap, kw = _case_maps(maps, case)
    tc = SumaConfig().small()
    icp_cfg = dataclasses.replace(tc.icp, **kw)
    tm, td, t0 = _port(model), _port(data), torch.from_numpy(inc)
    one = ticp.gauss_newton(td, tm, t0, icp_cfg, tc.model,
                            max_iterations=cap)
    reads0 = to_host.count
    got = ticp.gauss_newton(td, tm, t0, icp_cfg, tc.model,
                            max_iterations=cap, group=Group())
    assert to_host.count - reads0 == got.iterations
    assert isinstance(got.iterations, int)
    assert got.iterations == int(one.iterations)
    assert torch.equal(got.pose.view(torch.int32), one.pose.view(torch.int32))
    for a, b in zip(got.stats, one.stats):
        assert a.dtype == b.dtype
        assert torch.equal(a.reshape(1).view(torch.int32),
                           b.reshape(1).view(torch.int32))


@pytest.mark.parametrize("sampling", ["nearest", "bilinear"])
@pytest.mark.parametrize("weighting", ["huber", "turkey"])
def test_evaluate_matches_jax(maps, sampling, weighting):
    model, data, inc = maps
    jc, tc = JConfig().small(), SumaConfig().small()
    kw = {"sampling": sampling, "weighting": weighting}
    want = jicp.evaluate(jnp.asarray(inc), data, model,
                         dataclasses.replace(jc.icp, **kw), jc.model)
    reads0 = to_host.count
    calls0 = ticp.evaluate.calls
    got = ticp.evaluate(torch.from_numpy(inc), _port(data), _port(model),
                        dataclasses.replace(tc.icp, **kw), tc.model)
    assert to_host.count == reads0
    assert ticp.evaluate.calls == calls0 + 1
    assert all(isinstance(s, torch.Tensor) and s.dim() == 0 for s in got)
    for name in ("valid", "inlier", "outlier", "invalid"):
        v = getattr(got, name)
        assert v.dtype == torch.int32
        assert int(v) == int(getattr(want, name)), name
    assert int(got.inlier) > 0
    for name in ("error", "inlier_residual"):
        np.testing.assert_allclose(float(getattr(got, name)),
                                   float(getattr(want, name)), rtol=1e-5,
                                   err_msg=name)
