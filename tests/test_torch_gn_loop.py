"""Gauss-Newton as one device loop: kernel F's route (``ops/icp.py``:
``gn_loop``, through ``gauss_newton``), the plain versions of kernels D and
E (``icp_products_plain``, ``gn_update_plain``) that F's plain version runs
on a latch, and the source that F and D share, against the JAX package on
the CPU.

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
* The loop through ``gauss_newton`` and through ``gn_loop`` on a
  ``gn_state`` against JAX's ``gauss_newton`` (a ``while_loop``) with the
  same ``max_iterations``: a call that stops early, calls capped at 1 and 3
  iterations (F ends the trips itself now), one against an empty model
  (the solve gives a zero step: the pose stays and the loop stops at once),
  one whose factorization fails (a NaN vertex on a valid pixel poisons the
  sums in both packages: a NaN step, the pose kept; on the card every block
  of F must stop on it at once) and one with turkey weights and bilinear
  sampling. The pose within 1e-5, the iterations and the integer
  statistics exactly equal, the error sums within 1e-5 relative (1e-4 with
  turkey weights, as above); the loop reads the host nowhere, launches
  nothing on the CPU, and equals the trips of D and E's wrappers run to
  ``max_iterations`` on the latch to the bit.
* ``gn_update_plain`` changes nothing once the latch is set, the kernels'
  wrappers raise on a device that is neither the CPU nor CUDA, and
  ``gn_loop`` raises on a bad state or count on any device.
* ``csrc/icp.cu``'s constants, state layout and slot loop against
  ``ops/icp.py`` (``NPART``, ``_NTRI``, ``_THREADS``, ``_SF``, ``_SI``,
  ``gn_result``, ``_blocks``): F's bit equality with D and E rests on them.
* The pyramid's iteration total is a device tensor equal to JAX's.
"""
import torch_env  # noqa: F401  (first: one torch thread)

import dataclasses
import inspect
import re
from pathlib import Path

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


def _same(m):
    return m


CASES = {
    # name: (model transform, data transform, max_iterations, IcpConfig
    # fields)
    "stops-early": (_same, _same, None, {}),
    "capped-at-1": (_same, _same, 1, {}),
    "capped-at-3": (_same, _same, 3, {}),
    "empty-model": (_empty, _same, None, {}),
    "solve-fails": (_same, _poisoned, None, {}),
    "turkey-bilinear": (_same, _same, None,
                        {"weighting": "turkey", "sampling": "bilinear"}),
}


@pytest.fixture(scope="module")
def jax_runs(maps):
    """JAX's ``gauss_newton`` of each case, computed once a module (a
    worker): ``{case: (model, data, result)}``."""
    return {}


def _jax_run(jax_runs, maps, case):
    if case not in jax_runs:
        model_f, data_f, cap, kw = CASES[case]
        model, data, inc = maps
        model, data = model_f(model), data_f(data)
        jc = JConfig().small()
        jicp_cfg = dataclasses.replace(jc.icp, **kw)
        jax_runs[case] = (model, data, jicp.gauss_newton(
            data, model, jnp.asarray(inc), jicp_cfg, jc.model,
            max_iterations=cap))
    return jax_runs[case]


def _launches():
    return (ticp.icp_products.launches, ticp.gn_update.launches,
            ticp.gn_loop.launches)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("entry", ["gauss_newton", "gn_loop"])
def test_latched_loop_matches_jax_gauss_newton(maps, jax_runs, entry, case):
    """The loop through ``gauss_newton`` or ``gn_loop`` on a ``gn_state``
    (kernel F's route; on the CPU its plain version, which ends at the
    latch) against JAX's ``gauss_newton`` with the same ``max_iterations``:
    the iterations and the integer statistics exactly equal, the pose within
    1e-5, the two error sums within 1e-5 relative (1e-4 with turkey
    weights: ``(1 - (r/c)^2)^2`` cancels near the cutoff, as in
    ``test_icp_products_plain_matches_jax``). The trips of kernels D and E's
    wrappers run to ``max_iterations`` with no early exit (the latch holds
    the state) give the same bits, no host read is counted and no kernel
    launch."""
    _, _, cap, kw = CASES[case]
    model, data, rj = _jax_run(jax_runs, maps, case)
    inc = maps[2]
    tc = SumaConfig().small()
    icp_cfg = dataclasses.replace(tc.icp, **kw)
    tm, td = _port(model), _port(data)
    reads0 = to_host.count
    launches0 = _launches()
    if entry == "gauss_newton":
        rt = ticp.gauss_newton(td, tm, torch.from_numpy(inc), icp_cfg,
                               tc.model, max_iterations=cap)
    else:
        sf, si = ticp.gn_state(torch.from_numpy(inc))
        ticp.gn_loop(sf, si, td, ticp._pack_model_image(tm), icp_cfg,
                     tc.model, True,
                     icp_cfg.max_iterations if cap is None else cap)
        rt = ticp.gn_result(sf, si)
    trips = ticp.gauss_newton_latched(
        td, tm, torch.from_numpy(inc), icp_cfg, tc.model,
        max_iterations=cap, early_exit=False, products=ticp.icp_products,
        update=ticp.gn_update)
    assert to_host.count == reads0
    # the wrappers ran their plain versions: no kernel launch is counted
    assert _launches() == launches0
    assert isinstance(rt.iterations, torch.Tensor)
    assert rt.iterations.dtype == torch.int32
    assert int(rt.iterations) == int(rj.iterations)
    np.testing.assert_allclose(rt.pose.numpy(), np.asarray(rj.pose),
                               atol=1e-5)
    for name in ("valid", "inlier", "outlier", "invalid"):
        assert int(getattr(rt.stats, name)) == int(getattr(rj.stats, name)), \
            name
    rtol = 1e-4 if kw.get("weighting") == "turkey" else 1e-5
    for name in ("error", "inlier_residual"):
        np.testing.assert_allclose(float(getattr(rt.stats, name)),
                                   float(getattr(rj.stats, name)), rtol=rtol,
                                   err_msg=name)
    assert torch.equal(trips.pose, rt.pose)
    assert int(trips.iterations) == int(rt.iterations)
    assert all(torch.equal(a, b) for a, b in zip(trips.stats, rt.stats))

    k = int(rj.iterations)
    max_it = JConfig().small().icp.max_iterations
    if case in ("stops-early", "turkey-bilinear"):
        assert 1 < k < max_it
    elif cap is not None:
        assert k == cap
    else:  # one iteration, the pose kept
        assert k == 1
        np.testing.assert_array_equal(rt.pose.numpy(), inc)
        if case == "solve-fails":
            jc = JConfig().small()
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
    with pytest.raises(ValueError):
        ticp.gn_loop(sf, si, None, None, tc.icp, tc.model, True, 3)
    assert ticp.gn_loop.launches == 0


@pytest.mark.parametrize("bad", ["state_f", "state_i", "dtype",
                                 "max_iterations"])
def test_gn_loop_raises_on_a_bad_state(bad):
    """``gn_loop`` checks its state and count on every device, before the
    CPU's plain route."""
    tc = SumaConfig().small()
    sf, si = ticp.gn_state(torch.eye(4))
    cap = 3
    if bad == "state_f":
        sf = sf[:16]
    elif bad == "state_i":
        si = torch.zeros(6, dtype=torch.int32)
    elif bad == "dtype":
        si = si.to(torch.int64)
    else:
        cap = -1
    with pytest.raises(ValueError):
        ticp.gn_loop(sf, si, None, None, tc.icp, tc.model, True, cap)


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



def _constexprs(src: str) -> dict:
    """``constexpr int NAME = value`` of a CUDA source (several a line)."""
    out = {}
    for decl in re.findall(r"constexpr int ([^;]+);", src):
        for part in decl.split(","):
            name, value = (s.strip() for s in part.split("="))
            out[name] = int(value) if value.isdigit() else value
    return out


def test_kernel_source_matches_the_wrapper():
    """Kernel F's bit equality with kernels D and E rests on one partition
    and one state layout: ``csrc/icp.cu``'s constants against ``ops/icp.py``
    (the sums a slot, the triangle, the block, the state's sizes and
    fields as ``gn_state`` and ``gn_result`` read them), D's and F's loop
    over a slot's pixels, and ``_blocks``' slots covering every pixel once."""
    src = (Path(ticp.__file__).parent.parent / "csrc" / "icp.cu").read_text()
    c = _constexprs(src)
    assert (c["NPART"], c["NTRI"], c["THREADS"]) == (
        ticp.NPART, ticp._NTRI, ticp._THREADS)
    assert (c["SF"], c["SI"]) == (ticp._SF, ticp._SI)
    sf = torch.arange(ticp._SF, dtype=torch.float32)
    si = torch.arange(ticp._SI, dtype=torch.int32)
    r = ticp.gn_result(sf, si)
    assert r.pose.reshape(-1).tolist() == list(range(16))
    assert float(r.stats.error) == c["SF_ERR"]
    assert float(r.stats.inlier_residual) == c["SF_INRES"]
    assert int(r.iterations) == c["SI_K"]
    counts = [int(r.stats.valid), int(r.stats.inlier), int(r.stats.outlier),
              int(r.stats.invalid)]
    assert counts == list(range(c["SI_COUNTS"], c["SI_COUNTS"] + 4))
    sf0, si0 = ticp.gn_state(torch.eye(4))
    assert float(sf0[c["SF_LAST"]]) == float("inf")
    assert int(si0[c["SI_DONE"]]) == 0 and int(si0[c["SI_K"]]) == 0
    # the state's done flag as the plain versions read it
    assert "state_i[1]" in inspect.getsource(ticp.gn_loop_plain)
    assert c["SI_DONE"] == 1
    # one loop over a slot's pixels, which D (slot = block) and F share
    loops = re.findall(r"for \(int i = (.*?); i < q\.p; i \+= (.*?)\)", src)
    assert loops == [("s * THREADS + threadIdx.x", "nslots * THREADS")]
    for p in (1, 255, 256, 5000, 57600, 64 * 450, 64 * 225, 300_000):
        n = ticp._blocks(p)
        slots = [list(range(s * ticp._THREADS + t, p, n * ticp._THREADS))
                 for s in range(n) for t in range(ticp._THREADS)]
        cover = sorted(i for pix in slots for i in pix)
        assert cover == list(range(p)), p
    assert ticp._blocks(57600) == 225
    # F's grid: one block a slot, at most what the card holds at once
    assert ticp.gn_loop_grid(225, 2, 132) == 225
    assert ticp.gn_loop_grid(225, 1, 132) == 132
    assert ticp.gn_loop_grid(1024, 2, 132) == 264
