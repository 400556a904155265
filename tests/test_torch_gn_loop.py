"""Gauss-Newton as one latched device loop: the plain versions of kernels D
and E (``ops/icp.py``: ``icp_products_plain``, ``gn_update_plain``) and the
loop that the card runs, against the JAX package on the CPU.

Inputs: two scans of the JAX simulator 1.5 m apart at ``SumaConfig().small()``
(32x180), in a world where 30% of the buildings carry the movable label 10,
preprocessed by JAX, converted for the port.

* ``icp_products_plain`` against JAX's ``jacobian_products`` for nearest and
  bilinear sampling, huber, turkey and no weighting, semantic weights on and
  off, at iterations 0 and 1 (turkey weighs by ``k > 0`` from the device
  counter): the counters exactly equal; every product within 1e-5 of its
  Cauchy-Schwarz scale ``sqrt(AtA[i,i] AtA[j,j])`` (``AtA[6,6]`` is the
  inlier residual), which bounds the sum of the absolute terms, so that
  float32 sums taken in another order stay well inside it; the two error
  sums within 1e-5 relative, 1e-4 with turkey weights: ``(1 - (r/c)^2)^2``
  cancels near the cutoff ``c``, so one rounding of ``r`` that XLA's fused
  bilinear arithmetic takes otherwise moves a term by far more than an
  ulp (with bilinear sampling at iteration 1 JAX's inlier residual lies
  1.4e-5 from the float64 sum of the port's terms, the port's 2e-10).
* The latched loop run for all ``max_iterations`` trips with no early exit
  (the card's schedule) against JAX's ``gauss_newton`` (a ``while_loop``):
  a call that stops early, one that hits ``max_iterations=3``, one against
  an empty model (the solve gives a zero step: the pose stays and the loop
  stops at once) and one whose factorization fails (a NaN vertex on a valid
  pixel poisons the sums in both packages: a NaN step, the pose kept). The
  pose within 1e-5, the iterations and the integer statistics exactly
  equal, the error within 1e-5 relative; the loop reads the host nowhere
  and equals its early-exit run to the bit.
* ``gn_update_plain`` changes nothing once the latch is set, and the
  kernels' wrappers raise on a device that is neither the CPU nor CUDA.
* The pyramid's iteration total is a device tensor equal to JAX's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_suma_tpu.config import SumaConfig as JConfig
from semantic_suma_tpu.core.preprocessing import preprocess_scan as jpre
from semantic_suma_tpu.io import simulation as jsim
from semantic_suma_tpu.ops import icp as jicp
from semantic_suma_tpu.ops import pyramid as jpyr
from semantic_suma_tpu_torch.config import SumaConfig
from semantic_suma_tpu_torch.convert import maps_from_numpy
from semantic_suma_tpu_torch.device import to_host
from semantic_suma_tpu_torch.ops import icp as ticp
from semantic_suma_tpu_torch.ops import pyramid as tpyr


@pytest.fixture(scope="module")
def maps():
    """(model maps, data maps, initial increment) as JAX arrays: scans 3 and
    4, the true increment perturbed by a few centimetres."""
    cfg = JConfig().small()
    world = jsim.default_world(0, extent=45.0, movable_fraction=0.3)
    gt = jsim.circular_trajectory(10, radius=18.0, step=1.5)
    out = []
    for i in (3, 4):
        scan = jsim.render_scan(world, gt[i], cfg.data)
        out.append(jpre(scan.points, scan.labels, scan.probs, scan.valid,
                        False, cfg))
    inc = np.linalg.inv(np.asarray(gt[3])) @ np.asarray(gt[4])
    inc[:3, 3] += [0.05, -0.03, 0.01]
    return out[0], out[1], inc.astype(np.float32)


def _port(m):
    return maps_from_numpy(jax.tree.map(np.asarray, m), "cpu")


def _icp_cfgs(**kw):
    return (dataclasses.replace(JConfig().icp, **kw),
            dataclasses.replace(SumaConfig().icp, **kw))


def test_semantic_weights_matter_on_these_maps(maps):
    """The semantic cases below test something: the model sees movable
    labels, and the weights change the products."""
    model, data, inc = maps
    assert np.isin(np.asarray(model.sem_label), [10]).any()
    jc, mc = JConfig().icp, JConfig().small().model
    on = jicp.jacobian_products(jnp.asarray(inc), data, model, jc, mc, 0, True)
    off = jicp.jacobian_products(jnp.asarray(inc), data, model, jc, mc, 0,
                                 False)
    assert not np.allclose(np.asarray(on[0]), np.asarray(off[0]))


@pytest.mark.parametrize("semantic", [True, False])
@pytest.mark.parametrize("sampling", ["nearest", "bilinear"])
@pytest.mark.parametrize("weighting", ["huber", "turkey", "none"])
def test_icp_products_plain_matches_jax(maps, sampling, weighting, semantic):
    model, data, inc = maps
    jcfg, tcfg = _icp_cfgs(sampling=sampling, weighting=weighting)
    mcfg_j, mcfg_t = JConfig().small().model, SumaConfig().small().model
    tm, td = _port(model), _port(data)
    model_img = ticp._pack_model_image(tm)
    il = np.tril_indices(6)
    for it in (0, 1):
        jtj, jtf, sj = jicp.jacobian_products(jnp.asarray(inc), data, model,
                                              jcfg, mcfg_j, it, semantic)
        sf, si = ticp.gn_state(torch.from_numpy(inc), k=it)
        row = ticp.icp_products_plain(sf, si, td, model_img, tcfg, mcfg_t,
                                      semantic)
        assert row.shape == (1, ticp.NPART)
        got = row[0].numpy().astype(np.float64)
        jtj = np.asarray(jtj, np.float64)
        jtf = np.asarray(jtf, np.float64)
        # the counters: valid, inlier, outlier, invalid
        want_counts = [int(sj.valid), int(sj.inlier), int(sj.outlier),
                       int(sj.invalid)]
        assert got[29:33].tolist() == want_counts, (it, got[29:33])
        assert want_counts[1] > 0
        diag = np.append(np.diag(jtj), float(sj.inlier_residual))
        scale = np.sqrt(np.outer(diag, diag))
        np.testing.assert_array_less(np.abs(got[:21] - jtj[il]),
                                     1e-5 * scale[il] + 1e-30)
        np.testing.assert_array_less(np.abs(got[21:27] - jtf),
                                     1e-5 * scale[:6, 6] + 1e-30)
        rtol = 1e-4 if weighting == "turkey" else 1e-5
        np.testing.assert_allclose(got[27], float(sj.error), rtol=rtol)
        np.testing.assert_allclose(got[28], float(sj.inlier_residual),
                                   rtol=rtol)


def _poisoned(data):
    """``data`` with the vertex of its first valid pixel set to NaN."""
    vertex = np.array(data.vertex)
    valid = np.asarray(data.vertex_valid & data.normal_valid)
    r, c = np.argwhere(valid)[0]
    vertex[r, c] = np.nan
    return data._replace(vertex=jnp.asarray(vertex))


def _empty(model):
    return model._replace(vertex_valid=jnp.zeros_like(model.vertex_valid),
                          normal_valid=jnp.zeros_like(model.normal_valid))


CASES = {
    # name: (model, data, max_iterations) transforms
    "stops-early": (lambda m: m, lambda d: d, None),
    "capped-at-3": (lambda m: m, lambda d: d, 3),
    "empty-model": (_empty, lambda d: d, None),
    "solve-fails": (lambda m: m, _poisoned, None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_latched_loop_matches_jax_gauss_newton(maps, case):
    model_f, data_f, cap = CASES[case]
    model, data, inc = maps
    model, data = model_f(model), data_f(data)
    jc, tc = JConfig().small(), SumaConfig().small()
    rj = jicp.gauss_newton(data, model, jnp.asarray(inc), jc.icp, jc.model,
                           max_iterations=cap)
    tm, td = _port(model), _port(data)
    reads0 = to_host.count
    launches0 = (ticp.icp_products.launches, ticp.gn_update.launches)
    rt = ticp.gauss_newton(td, tm, torch.from_numpy(inc), tc.icp, tc.model,
                           max_iterations=cap, early_exit=False)
    assert to_host.count == reads0
    # the wrappers ran their plain versions: no kernel launch is counted
    assert (ticp.icp_products.launches, ticp.gn_update.launches) == launches0
    assert isinstance(rt.iterations, torch.Tensor)
    assert rt.iterations.dtype == torch.int32
    assert int(rt.iterations) == int(rj.iterations)
    np.testing.assert_allclose(rt.pose.numpy(), np.asarray(rj.pose),
                               atol=1e-5)
    for name in ("valid", "inlier", "outlier", "invalid"):
        assert int(getattr(rt.stats, name)) == int(getattr(rj.stats, name)), \
            name
    np.testing.assert_allclose(float(rt.stats.error), float(rj.stats.error),
                               rtol=1e-5)
    # the early-exit run (the CPU's) ends at the latch with the same bits
    re = ticp.gauss_newton(td, tm, torch.from_numpy(inc), tc.icp, tc.model,
                           max_iterations=cap)
    assert torch.equal(re.pose, rt.pose)
    assert int(re.iterations) == int(rt.iterations)
    assert all(torch.equal(a, b) for a, b in zip(re.stats, rt.stats))

    k = int(rj.iterations)
    if case == "stops-early":
        assert 1 < k < jc.icp.max_iterations
    elif case == "capped-at-3":
        assert k == 3
    else:  # one iteration, the pose kept
        assert k == 1
        np.testing.assert_array_equal(rt.pose.numpy(), inc)
        if case == "solve-fails":
            assert not np.isfinite(np.asarray(
                jicp.jacobian_products(jnp.asarray(inc), data, model, jc.icp,
                                       jc.model)[0])).all()


def test_latch_holds_the_state(maps):
    """A done state goes through ``gn_update_plain`` unchanged, whatever
    the partial sums say."""
    model, data, inc = maps
    tc = SumaConfig().small()
    tm, td = _port(model), _port(data)
    sf, si = ticp.gn_state(torch.from_numpy(inc))
    img = ticp._pack_model_image(tm)
    row = ticp.icp_products_plain(sf, si, td, img, tc.icp, tc.model)
    si[1] = 1
    before = (sf.clone(), si.clone())
    ticp.gn_update_plain(row, sf, si, tc.icp)
    assert torch.equal(sf, before[0]) and torch.equal(si, before[1])
    si[1] = 0
    ticp.gn_update_plain(row, sf, si, tc.icp)
    assert int(si[0]) == 1 and not torch.equal(sf[:16], before[0][:16])


def test_wrappers_raise_off_the_cpu_and_cuda():
    meta = torch.device("meta")
    sf, si = (torch.zeros(20, device=meta),
              torch.zeros(8, dtype=torch.int32, device=meta))
    tc = SumaConfig().small()
    with pytest.raises(ValueError):
        ticp.gn_update(torch.zeros((1, ticp.NPART), device=meta), sf, si,
                       tc.icp)
    with pytest.raises(ValueError):
        ticp.icp_products(sf, si, None, None, tc.icp, tc.model)


def test_pyramid_iterations_summed_on_the_device(maps):
    model, data, inc = maps
    jc, tc = JConfig().small(), SumaConfig().small()
    rj = jpyr.gauss_newton_pyramid(data, model, jnp.asarray(inc), jc.icp,
                                   jc.model, levels=3)
    reads0 = to_host.count
    rt = tpyr.gauss_newton_pyramid(_port(data), _port(model),
                                   torch.from_numpy(inc), tc.icp, tc.model,
                                   levels=3)
    assert to_host.count == reads0
    assert isinstance(rt.iterations, torch.Tensor)
    assert int(rt.iterations) == int(rj.iterations)
    np.testing.assert_allclose(rt.pose.numpy(), np.asarray(rj.pose),
                               atol=1e-4)

