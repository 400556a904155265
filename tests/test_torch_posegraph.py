"""The port's pose graph against the JAX package on the CPU.

* ``_residuals``, ``_edge_jacobians`` (atol 1e-5: float32 forward-mode
  derivatives through the same closed forms) and ``_robust_weights`` for all
  three kernels (atol 1e-6) on a seeded 40-pose ring with one true and one
  false robust closure.
* ``optimize`` on that ring after the same iteration caps: poses within 1e-4
  of JAX for ``none`` and ``huber`` at the default cap of 10 and for ``dcs``
  at a cap of 8. From 10 iterations on the two ``dcs`` solves part by up to
  4e-3 at an equal final error (3.99927): next to convergence the
  step-acceptance test compares two errors that differ in the last bits, so
  one package takes a step along the false closure's flat direction that the
  other refuses. Those cases are held at 1e-2.
* The port's counterparts of the nine cases of ``tests/test_posegraph.py``,
  and the converter ``convert.posegraph_from_jax``.
"""
import torch_env  # noqa: F401  (first: one torch thread)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_suma_tpu.core import posegraph as jpg
from semantic_suma_tpu.utils import lie as jlie
from semantic_suma_tpu_torch.convert import posegraph_from_jax
from semantic_suma_tpu_torch.core import posegraph as tpg
from semantic_suma_tpu_torch.utils import lie as tlie

KERNELS = ("none", "huber", "dcs")


def _exp(x):
    return tlie.se3_exp(torch.as_tensor(x, dtype=torch.float32)).numpy()


class _Cpu(tpg.Posegraph):
    """The port's graph, solved where the tests run."""

    def optimize(self, *args, **kw):
        return super().optimize(*args, device="cpu", **kw)


def _ring(cls, n=40, seed=0, loop_info=100.0, false_edge=True, robust=True):
    """Noisy odometry around a ring, one true closure n-1 -> 0 and (optionally)
    one wildly false closure n/2 -> 3."""
    rng = np.random.default_rng(seed)
    inc = _exp([1.0, 0, 0, 0, 0, 2 * np.pi / n])
    g = cls()
    g.set_initial(0, np.eye(4))
    truth, est = [np.eye(4)], [np.eye(4)]
    for i in range(1, n):
        truth.append(truth[-1] @ inc)
        meas = inc @ _exp(rng.normal(0, 0.01, 6) * [1, 1, 0.2, 0.1, 0.1, 1])
        est.append(est[-1] @ meas)
        g.set_initial(i, est[-1])
        g.add_edge(i - 1, i, meas)
    g.add_edge(n - 1, 0, np.linalg.inv(truth[-1]) @ truth[0],
               np.full(6, loop_info, np.float32), robust=robust)
    if false_edge:
        g.add_edge(n // 2, 3, _exp([0, 12.0, 0, 0, 0, 1.5]),
                   np.full(6, 50.0, np.float32), robust=True)
    return g, truth


def _pair():
    gj, _ = _ring(jpg.Posegraph)
    gt, _ = _ring(_Cpu)
    return gj, gt, gj.to_device(), gt.to_device(device="cpu")


def test_residuals_and_jacobians_match_jax():
    gj, gt, dj, dt = _pair()
    e = len(gt._edges)
    assert dt.edge_i.shape[0] == e and bool(dt.edge_valid.all())
    np.testing.assert_allclose(tpg._residuals(dt.poses, dt).numpy(),
                               np.asarray(jpg._residuals(dj.poses, dj))[:e],
                               atol=1e-5)
    jij, jjj = jpg._edge_jacobians(dj.poses, dj)
    tij, tjj = tpg._edge_jacobians(dt.poses, dt)
    np.testing.assert_allclose(tij.numpy(), np.asarray(jij)[:e], atol=1e-5)
    np.testing.assert_allclose(tjj.numpy(), np.asarray(jjj)[:e], atol=1e-5)


@pytest.mark.parametrize("kernel", KERNELS)
def test_robust_weights_and_cost_match_jax(kernel):
    gj, gt, dj, dt = _pair()
    e = len(gt._edges)
    rj = jpg._residuals(dj.poses, dj)
    rt = tpg._residuals(dt.poses, dt)
    wj = np.asarray(jpg._robust_weights(rj, dj, kernel, 1.0))[:e]
    wt = tpg._robust_weights(rt, dt, kernel, 1.0).numpy()
    np.testing.assert_allclose(wt, wj, atol=1e-6)
    if kernel != "none":
        assert wt[-1] < 0.1 and wt[:e - 2].min() == 1.0  # only loop edges
    cj = float(jpg._robust_cost(rj, dj, kernel, 1.0))
    ct = float(tpg._robust_cost(rt, dt, kernel, 1.0))
    assert abs(ct - cj) <= 1e-5 * max(1.0, abs(cj))


@pytest.mark.parametrize("kernel,cap,tol", [
    ("none", 10, 1e-4), ("huber", 10, 1e-4), ("dcs", 8, 1e-4),
    ("dcs", 10, 1e-2), ("dcs", 15, 1e-2)])
def test_optimize_matches_jax(kernel, cap, tol):
    gj, _ = _ring(jpg.Posegraph)
    gt, _ = _ring(_Cpu)
    ej = gj.optimize(cap, kernel, 1.0)
    et = gt.optimize(cap, kernel, 1.0)
    np.testing.assert_allclose(np.stack(gt.poses()), np.stack(gj.poses()),
                               atol=tol)
    assert abs(et - ej) <= 1e-4 * max(1.0, abs(ej))


def test_posegraph_from_jax_carries_poses_and_edges():
    gj, _ = _ring(jpg.Posegraph)
    gt = posegraph_from_jax(gj.poses(), gj._edges)
    assert gt.size() == gj.size() and len(gt._edges) == len(gj._edges)
    dj, dt = gj.to_device(), gt.to_device(device="cpu")
    e = len(gt._edges)
    for name in ("edge_i", "edge_j", "edge_z", "edge_info", "edge_robust"):
        np.testing.assert_array_equal(getattr(dt, name).numpy(),
                                      np.asarray(getattr(dj, name))[:e], name)
    np.testing.assert_array_equal(dt.poses.numpy(),
                                  np.asarray(dj.poses)[:gt.size()])


def test_lie_closed_forms_differentiate_like_jax():
    """The Jacobians come from forward-mode derivatives through the port's
    ``se3_exp``/``se3_log``: hold d log(X exp(d)) / d d at d = 0 to JAX's,
    at a generic pose and next to the identity (atol 1e-5)."""
    import jax
    for twist in ([0.3, -0.2, 0.1, 0.2, -0.4, 0.9], [1e-4, 0, 0, 0, 1e-5, 0]):
        x = _exp(twist)
        jj = np.asarray(jax.jacfwd(lambda d: jlie.se3_log(
            jnp.asarray(x) @ jlie.se3_exp(d)))(jnp.zeros(6, jnp.float32)))
        xt = torch.from_numpy(x)
        basis = torch.eye(6)
        # a batch of one: the residuals are always differentiated in batches
        cols = [torch.func.jvp(lambda d: tlie.se3_log(xt @ tlie.se3_exp(d)),
                               (torch.zeros(1, 6),), (basis[k][None],))[1][0]
                for k in range(6)]
        np.testing.assert_allclose(torch.stack(cols, -1).numpy(), jj,
                                   atol=1e-5)


# ---- the port's counterparts of tests/test_posegraph.py -----------------

def _chain_graph(n=30, loop_edges=()):
    g = _Cpu()
    inc = _exp([1.0, 0, 0, 0, 0, 0])
    g.set_initial(0, np.eye(4))
    pose = np.eye(4)
    for i in range(1, n):
        pose = pose @ inc
        g.set_initial(i, pose)
        g.add_edge(i - 1, i, inc)
    for (i, j, z, info, robust) in loop_edges:
        g.add_edge(i, j, z, info, robust=robust)
    return g


_BAD = (_exp([0.0, 12.0, 0, 0, 0, 1.5]), np.full(6, 50.0, np.float32))


def _case_two_pose_chain():
    g = _Cpu()
    g.set_initial(0, np.eye(4))
    z = _exp([1.0, 0.0, 0.0, 0.0, 0.0, 0.1])
    g.set_initial(1, _exp([1.3, 0.2, 0.0, 0.0, 0.0, 0.0]))  # bad init
    g.add_edge(0, 1, z)
    err = g.optimize()
    np.testing.assert_allclose(g.pose(0), np.eye(4), atol=1e-3)
    np.testing.assert_allclose(g.pose(1), z, atol=1e-3)
    assert err < 1e-6


def _closes(robust, **opt):
    n = 40
    g, truth = _ring(_Cpu, n=n, seed=1 if robust else 0, false_edge=False,
                     robust=robust)
    before = np.linalg.norm((np.linalg.inv(g.pose(n - 1)) @ truth[-1])[:3, 3])
    g.optimize(max_iterations=15, **opt)
    after = np.linalg.norm((np.linalg.inv(g.pose(n - 1)) @ truth[-1])[:3, 3])
    assert after < 0.5 * before or before < 0.05
    return g, truth


def _case_loop_closure_distributes_drift():
    g, truth = _closes(False)
    n = len(truth)
    closure = np.linalg.norm(
        (np.linalg.inv(g.pose(n - 1) @ np.linalg.inv(truth[-1]) @ truth[0])
         @ g.pose(0))[:3, 3])
    assert closure < 0.1


def _case_prior_anchors_first_pose():
    g = _Cpu()
    g.set_initial(0, np.eye(4))
    g.set_initial(1, _exp([2.0, 0, 0, 0, 0, 0]))
    g.add_edge(0, 1, _exp([1.0, 0, 0, 0, 0, 0]))
    g.optimize()
    np.testing.assert_allclose(g.pose(0), np.eye(4), atol=1e-3)
    np.testing.assert_allclose(g.pose(1)[:3, 3], [1.0, 0, 0], atol=1e-3)


def _case_empty_and_trivial():
    g = _Cpu()
    assert g.optimize() == 0.0
    g.set_initial(0, np.eye(4))
    assert g.optimize() == 0.0


def _end_error(robust, **opt):
    n = 30
    g = _chain_graph(n, [(n - 1, 0, _BAD[0], _BAD[1], robust)])
    g.optimize(max_iterations=15, **opt)
    return np.linalg.norm(g.pose(n - 1)[:3, 3] - [n - 1.0, 0, 0])


def _case_false_closure_corrupts_without_robust_kernel():
    assert _end_error(False) > 1.0


def _case_false_closure_damped_by_dcs():
    assert _end_error(True, robust_kernel="dcs", robust_delta=1.0) < 0.5
    err_h = _end_error(True, robust_kernel="huber", robust_delta=1.0)
    assert err_h <= _end_error(False) + 0.5


def _case_true_closure_survives_robust_kernel():
    _closes(True, robust_kernel="dcs", robust_delta=1.0)


def _case_edge_buffer_grows_past_capacity():
    g = _Cpu(edge_capacity=8)
    inc = _exp([1.0, 0, 0, 0, 0, 0])
    g.set_initial(0, np.eye(4))
    pose = np.eye(4)
    for i in range(1, 24):
        pose = pose @ inc
        g.set_initial(i, pose)
        g.add_edge(i - 1, i, inc)
    err = g.optimize()
    assert g.edge_capacity >= 23
    assert err < 1e-6
    np.testing.assert_allclose(g.pose(23)[:3, 3], [23.0, 0, 0], atol=1e-3)


def _case_edge_mirror_invalidated_on_list_replacement():
    g = _Cpu()
    g.set_initial(0, np.eye(4))
    g.set_initial(1, np.eye(4))
    g.add_edge(0, 1, _exp([1.0, 0, 0, 0, 0, 0]))
    g.optimize()
    np.testing.assert_allclose(g.pose(1)[:3, 3], [1.0, 0, 0], atol=1e-3)
    g._edges = [(0, 1, _exp([0.0, 2.0, 0, 0, 0, 0]),
                 np.ones(6, np.float32), False)]
    g.optimize()
    np.testing.assert_allclose(g.pose(1)[:3, 3], [0.0, 2.0, 0], atol=1e-3)


CASES = [v for k, v in sorted(globals().items()) if k.startswith("_case_")]


@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__[6:])
def test_posegraph_case(case):
    case()


def test_optimize_needs_a_gpu_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    g = _chain_graph(4)
    with pytest.raises(RuntimeError):
        tpg.Posegraph.optimize(g)
