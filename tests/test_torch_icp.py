"""The port's ICP against the JAX package on the same maps: Jacobian products
(nearest and bilinear sampling; huber, turkey and no weighting) with integer
statistics exactly equal, and the Gauss-Newton pose at atol 1e-5."""
import torch_env  # noqa: F401  (first: one torch thread)

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
from semantic_suma_tpu_torch.config import SumaConfig
from semantic_suma_tpu_torch.convert import maps_from_numpy
from semantic_suma_tpu_torch.device import to_host
from semantic_suma_tpu_torch.ops import icp as ticp


@pytest.fixture(scope="module")
def maps():
    cfg = JConfig().small()
    world = jsim.default_world(0, extent=45.0)
    gt = jsim.circular_trajectory(10, radius=18.0, step=1.5)
    out = []
    for i in (3, 4):
        scan = jsim.render_scan(world, gt[i], cfg.data)
        out.append(jpre(scan.points, scan.labels, scan.probs, scan.valid,
                        False, cfg))
    # the ground-truth increment from scan 4 to scan 3, slightly perturbed
    inc = np.linalg.inv(np.asarray(gt[3])) @ np.asarray(gt[4])
    inc[:3, 3] += [0.05, -0.03, 0.01]
    return out[0], out[1], inc.astype(np.float32)


def _both(m):
    return m, maps_from_numpy(jax.tree.map(np.asarray, m), "cpu")


@pytest.mark.parametrize("sampling", ["nearest", "bilinear"])
@pytest.mark.parametrize("weighting", ["huber", "turkey", "none"])
def test_jacobian_products_match_jax(maps, sampling, weighting):
    model, data, inc = maps
    jcfg = dataclasses.replace(JConfig().icp, sampling=sampling,
                               weighting=weighting)
    tcfg = dataclasses.replace(SumaConfig().icp, sampling=sampling,
                               weighting=weighting)
    mcfg_j, mcfg_t = JConfig().small().model, SumaConfig().small().model
    (jm, tm), (jd, td) = _both(model), _both(data)
    for it in (0, 1):
        jtj_j, jtf_j, sj = jicp.jacobian_products(jnp.asarray(inc), jd, jm,
                                                  jcfg, mcfg_j, it)
        jtj_t, jtf_t, st = ticp.jacobian_products(torch.from_numpy(inc), td,
                                                  tm, tcfg, mcfg_t, it)
        for name in ("valid", "inlier", "outlier", "invalid"):
            assert int(getattr(st, name)) == int(getattr(sj, name)), name
        np.testing.assert_allclose(float(st.error), float(sj.error),
                                   rtol=1e-4)
        scale = np.abs(np.asarray(jtj_j)).max()
        np.testing.assert_allclose(jtj_t.numpy(), np.asarray(jtj_j),
                                   atol=1e-5 * scale)
        np.testing.assert_allclose(jtf_t.numpy(), np.asarray(jtf_j),
                                   atol=1e-5 * scale)


def test_gauss_newton_matches_jax(maps):
    model, data, inc = maps
    jc, tc = JConfig().small(), SumaConfig().small()
    (jm, tm), (jd, td) = _both(model), _both(data)
    rj = jicp.gauss_newton(jd, jm, jnp.asarray(inc), jc.icp, jc.model)
    reads0 = to_host.count
    rt = ticp.gauss_newton(td, tm, torch.from_numpy(inc), tc.icp, tc.model)
    np.testing.assert_allclose(rt.pose.numpy(), np.asarray(rj.pose),
                               atol=1e-5)
    assert rt.iterations == int(rj.iterations)
    assert to_host.count - reads0 == 0  # the latched loop reads nothing
