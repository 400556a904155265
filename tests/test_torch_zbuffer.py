"""The port's z-buffer (plain version of the CUDA kernel) against the JAX sort
formulation: winners exactly equal, on random inputs with forced depth ties,
invalid ids and depths beyond the bound, in both the packed-key and the exact
two-key branch; and ``project_scan`` maps (integers exact, floats 1e-6)."""
import torch_env  # noqa: F401  (first: one torch thread)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_suma_tpu.config import DataConfig as JData
from semantic_suma_tpu.io import simulation as jsim
from semantic_suma_tpu.ops import projection as jproj
from semantic_suma_tpu.ops import zbuffer as jzb
from semantic_suma_tpu_torch.config import DataConfig
from semantic_suma_tpu_torch.ops import projection as tproj
from semantic_suma_tpu_torch.ops import zbuffer as tzb


def _inputs(n, cells, seed, span=None):
    """Random candidates; ``span`` crowds the valid ids into the first
    ``span`` cells so that every cell sees many candidates."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(-50, cells + 50, size=n).astype(np.int32)
    if span is not None:
        ids = np.where(ids < 0, ids, ids % span).astype(np.int32)
    depth = rng.uniform(0.0, 140.0, size=n).astype(np.float32)  # > bound too
    depth[: n // 3] = np.round(depth[: n // 3])                  # ties
    depth[n // 3: n // 3 + 8] = 0.0
    depth[n // 3 + 8: n // 3 + 12] = -0.0
    depth[n // 3 + 12: n // 3 + 16] = -3.0
    nans = np.array([0x7FC00000, 0xFFC00000, 0x7FC00001, 0x7F800001],
                    np.uint32).view(np.float32)                  # any NaN
    depth[n // 3 + 16: n // 3 + 20] = nans
    depth[n // 3 + 20: n // 3 + 24] = np.inf
    flags = [rng.uniform(size=n) < p for p in (0.5, 0.2)]
    return ids, depth, flags


# 2^12 cells pack (14 depth bits); 2^20 cells take the exact two-key branch
@pytest.mark.parametrize("n,cells,span", [(5000, 4096, None),
                                          (3000, 700, None),
                                          (6000, 1 << 20, None),
                                          (6000, 1 << 20, 64)])
def test_zbuffer_argmin_matches_jax(n, cells, span):
    ids, depth, _ = _inputs(n, cells, seed=n, span=span)
    wj, dj = jzb.zbuffer_argmin(jnp.asarray(ids), jnp.asarray(depth), cells)
    wt, dt = tzb.zbuffer_argmin(torch.from_numpy(ids).long(),
                                torch.from_numpy(depth), cells)
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))


@pytest.mark.parametrize("n,cells,span", [(5000, 4096, None),
                                          (6000, 1 << 20, None),
                                          (6000, 1 << 20, 64)])
def test_zbuffer_runs_matches_jax(n, cells, span):
    ids, depth, flags = _inputs(n, cells, seed=n + 1, span=span)
    jw, jws, jds = jzb.zbuffer_runs(
        jnp.asarray(ids), jnp.asarray(depth),
        tuple(jnp.asarray(f) for f in flags), cells,
        flag_payloads=(True, False))
    tw, tws, tds = tzb.zbuffer_runs(
        torch.from_numpy(ids).long(), torch.from_numpy(depth),
        tuple(torch.from_numpy(f) for f in flags), cells,
        flag_payloads=(True, False))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    for a, b in zip(jws, tws):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for a, b in zip(jds, tds):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def _runs_kw(cells):
    exact, scale, qmax = tzb._quantization(cells, 100.0)
    return dict(exact=exact, scale=scale, qclip=max(qmax - 1, 0),
                qoff=0 if exact else 1)


# the widened kernel function (winners AND finished depths in one call), plain
# version: exact against the JAX sorts, decoded depths bit for bit in float32
@pytest.mark.parametrize("n,cells,span", [(5000, 4096, None),
                                          (4000, 700, 40),
                                          (6000, 1 << 20, None),
                                          (6000, 1 << 20, 64)])
def test_zbuffer_cells_plain_matches_jax(n, cells, span):
    ids, depth, flags = _inputs(n, cells, seed=n + 2, span=span)
    tflags = tuple(torch.from_numpy(f) for f in flags)
    jw, jws, jds = jzb.zbuffer_runs(
        jnp.asarray(ids), jnp.asarray(depth),
        tuple(jnp.asarray(f) for f in flags), cells,
        flag_payloads=(True, False))
    w, d = tzb.zbuffer_cells_plain(
        torch.from_numpy(ids), torch.from_numpy(depth), tflags, cells,
        payloads=(True, False), **_runs_kw(cells))
    assert w.dtype == torch.int64 and d.dtype == torch.float32
    assert w.shape == d.shape == (3, cells)
    np.testing.assert_array_equal(w[0].numpy(), np.asarray(jw))
    for k in range(2):
        np.testing.assert_array_equal(w[1 + k].numpy(), np.asarray(jws[k]))
        np.testing.assert_array_equal(d[1 + k].numpy().view(np.int32),
                                      np.asarray(jds[k]).view(np.int32))
    # existence only: 0 / -1 and 0.0 / inf
    assert set(np.unique(w[2].numpy())) <= {-1, 0}
    np.testing.assert_array_equal(np.isinf(d[2].numpy()), w[2].numpy() < 0)
    # query 0 carries the winner's own depth, as zbuffer_argmin reports it
    exact, scale, qmax = tzb._quantization(cells, 100.0)
    aw, ad = jzb.zbuffer_argmin(jnp.asarray(ids), jnp.asarray(depth), cells)
    w0, d0 = tzb.zbuffer_cells_plain(
        torch.from_numpy(ids), torch.from_numpy(depth), (), cells,
        exact=exact, scale=scale, qclip=qmax, qoff=0)
    np.testing.assert_array_equal(w0[0].numpy(), np.asarray(aw))
    np.testing.assert_array_equal(d0[0].numpy().view(np.int32),
                                  np.asarray(ad).view(np.int32))


@pytest.mark.parametrize("cells", [4096, 1 << 20])
def test_zbuffer_takes_int32_ids_and_bool_flags(cells):
    ids, depth, flags = _inputs(5000, cells, seed=11, span=300)
    d = torch.from_numpy(depth)
    a = tzb.zbuffer_runs(torch.from_numpy(ids), d,
                         tuple(torch.from_numpy(f) for f in flags), cells,
                         flag_payloads=(True, False))
    b = tzb.zbuffer_runs(torch.from_numpy(ids).long(), d,
                         tuple(torch.from_numpy(f.astype(np.uint8))
                               for f in flags), cells,
                         flag_payloads=(True, False))
    assert torch.equal(a[0], b[0]) and a[0].dtype == torch.int64
    for x, y in zip(a[1] + a[2], b[1] + b[2]):
        assert x.dtype == y.dtype and torch.equal(x, y)
    wa, da = tzb.zbuffer_argmin(torch.from_numpy(ids), d, cells)
    wb, db = tzb.zbuffer_argmin(torch.from_numpy(ids).long(), d, cells)
    assert torch.equal(wa, wb) and torch.equal(
        da.view(torch.int32), db.view(torch.int32))


@pytest.mark.parametrize("cells", [700, 1 << 20])
def test_zbuffer_empty_input(cells):
    ids = torch.zeros((0,), dtype=torch.int32)
    depth = torch.zeros((0,), dtype=torch.float32)
    flags = (torch.zeros((0,), dtype=torch.bool),) * 2
    w, d = tzb.zbuffer_argmin(ids, depth, cells)
    assert w.shape == d.shape == (cells,)
    assert bool((w == -1).all()) and bool(torch.isinf(d).all())
    w0, ws, ds = tzb.zbuffer_runs(ids, depth, flags, cells,
                                  flag_payloads=(True, False))
    assert bool((w0 == -1).all())
    for a, b in zip(ws, ds):
        assert a.shape == b.shape == (cells,) and a.dtype == torch.int64
        assert bool((a == -1).all()) and bool(torch.isinf(b).all())
    if cells == 700:
        # the JAX exact branch gathers depth[0] and cannot take n = 0
        jw0, jws, jds = jzb.zbuffer_runs(
            jnp.zeros((0,), jnp.int32), jnp.zeros((0,), jnp.float32),
            (jnp.zeros((0,), bool),) * 2, cells, flag_payloads=(True, False))
        np.testing.assert_array_equal(w0.numpy(), np.asarray(jw0))
        for a, b in zip(jws + jds, ws + ds):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_scatter_sum_and_gather_or():
    rng = np.random.default_rng(5)
    ids = rng.integers(-3, 40, size=200).astype(np.int32)
    vals = rng.normal(size=(200, 3)).astype(np.float32)
    a = np.asarray(jzb.scatter_reduce_sum(jnp.asarray(ids), jnp.asarray(vals),
                                          37))
    b = tzb.scatter_reduce_sum(torch.from_numpy(ids).long(),
                               torch.from_numpy(vals), 37).numpy()
    np.testing.assert_allclose(b, a, atol=1e-5)
    win = rng.integers(-1, 200, size=50).astype(np.int32)
    np.testing.assert_array_equal(
        tzb.gather_or(torch.from_numpy(win).long(), torch.from_numpy(vals),
                      -7.0).numpy(),
        np.asarray(jzb.gather_or(jnp.asarray(win), jnp.asarray(vals), -7.0)))


@pytest.mark.parametrize("averaging", [False, True])
def test_project_scan_matches_jax(averaging):
    world = jsim.default_world(0, extent=45.0)
    pose = jsim.circular_trajectory(10, radius=18.0, step=1.5)[3]
    jd = JData(width=180, height=32)
    scan = jsim.render_scan(world, pose, jd, noise_sigma=0.02,
                            key=jax.random.PRNGKey(0))
    rng = np.random.default_rng(2)
    extra = rng.normal(size=(500, 3)).astype(np.float32) * 20
    pts = np.concatenate([np.asarray(scan.points), extra])
    labels = np.concatenate([np.asarray(scan.labels),
                             rng.integers(0, 60, 500)]).astype(np.int32)
    probs = rng.uniform(size=len(pts)).astype(np.float32)
    valid = np.concatenate([np.asarray(scan.valid), np.ones(500, bool)])
    a = jproj.project_scan(jnp.asarray(pts), jnp.asarray(labels),
                           jnp.asarray(probs), cfg=jd,
                           point_valid=jnp.asarray(valid),
                           averaging=averaging)
    b = tproj.project_scan(torch.from_numpy(pts), torch.from_numpy(labels),
                           torch.from_numpy(probs),
                           cfg=DataConfig(width=180, height=32),
                           point_valid=torch.from_numpy(valid),
                           averaging=averaging)
    for name in a._fields:
        x, y = np.asarray(getattr(a, name)), getattr(b, name).numpy()
        if x.dtype.kind in "biu":
            np.testing.assert_array_equal(y, x, err_msg=name)
        else:
            np.testing.assert_allclose(y, x, atol=1e-6, err_msg=name)
