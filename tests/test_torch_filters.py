"""The port's range-image filters against the JAX package: the plain
bilateral filter (the CPU side of the CUDA kernel) against the Pallas kernel in
interpret mode at rtol = atol = 2e-5; normals, erosion and flood fill; and
``preprocess_scan`` with the bilateral filter on at ``small()``."""
import torch_env  # noqa: F401  (first: one torch thread)

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from semantic_suma_tpu.config import SumaConfig as JConfig
from semantic_suma_tpu.core.preprocessing import preprocess_scan as jpre
from semantic_suma_tpu.io import simulation as jsim
from semantic_suma_tpu.ops import filters as jf
from semantic_suma_tpu.ops.pallas_kernels import bilateral_filter_pallas
from semantic_suma_tpu_torch.config import SumaConfig
from semantic_suma_tpu_torch.core.preprocessing import preprocess_scan as tpre
from semantic_suma_tpu_torch.ops import filters as tf
from semantic_suma_tpu_torch.ops.bilateral import (bilateral_filter,
                                                   bilateral_filter_plain)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("radius,sigma_range,holes", [
    (3, 30.0, False), (6, 2.5, False),
    (3, 30.0, True), (6, 2.5, True), (6, 1e6, True)])
def test_bilateral_plain_matches_pallas(radius, sigma_range, holes):
    rng = np.random.default_rng(3)
    h, w = 16, 128
    pts = rng.normal(size=(h, w, 3)).astype(np.float32) * 5 + 10
    valid = rng.uniform(size=(h, w)) < 0.9
    if holes:
        # half of the pixels invalid on the rows next to the outside and on
        # the columns that wrap
        for sl in ((0, slice(None)), (h - 1, slice(None)),
                   (slice(None), 0), (slice(None), w - 1)):
            valid[sl] = rng.uniform(size=valid[sl].shape) < 0.5
    # unjitted, so the sigmas stay Python constants of the Pallas kernel
    # (a jitted call would trace them, which the kernel does not accept)
    want = bilateral_filter_pallas.__wrapped__(
        jnp.asarray(pts), jnp.asarray(valid), sigma_space=4.5,
        sigma_range=sigma_range, radius=radius, interpret=True)
    got = bilateral_filter_plain(_t(pts), _t(valid), 4.5, sigma_range, radius)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    # on a CPU tensor the kernel's wrapper runs the plain version
    assert torch.equal(bilateral_filter(_t(pts), _t(valid), 4.5, sigma_range,
                                        radius), got)


def test_bilateral_takes_bool_or_uint8_validity():
    rng = np.random.default_rng(8)
    pts = rng.normal(size=(8, 64, 3)).astype(np.float32) * 5 + 10
    valid = rng.uniform(size=(8, 64)) < 0.8
    a = bilateral_filter(_t(pts), _t(valid), 4.5, 2.5, 3)
    b = bilateral_filter(_t(pts), _t(valid.astype(np.uint8)), 4.5, 2.5, 3)
    assert torch.equal(a, b)


def _scan_maps():
    cfg = JConfig().small()
    world = jsim.default_world(0, extent=45.0)
    pose = jsim.circular_trajectory(10, radius=18.0, step=1.5)[4]
    scan = jsim.render_scan(world, pose, cfg.data)
    m = jpre(scan.points, scan.labels, scan.probs, scan.valid, True, cfg)
    return scan, m


def test_normals_erosion_floodfill_match_jax():
    _, m = _scan_maps()
    vm, vv = np.asarray(m.vertex), np.asarray(m.vertex_valid)
    rng = np.random.default_rng(4)
    labels = np.where(vv, rng.choice([0, 10, 40, 50], size=vv.shape),
                      0).astype(np.int32)
    probs = rng.uniform(size=vv.shape).astype(np.float32)

    nj, nvj = jf.compute_normals(jnp.asarray(vm), jnp.asarray(vv))
    nt, nvt = tf.compute_normals(_t(vm), _t(vv))
    np.testing.assert_array_equal(nvt.numpy(), np.asarray(nvj))
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), atol=1e-5)

    lj, pj = jf.erode_semantics(jnp.asarray(labels), jnp.asarray(probs),
                                jnp.asarray(vv))
    lt, pt = tf.erode_semantics(_t(labels), _t(probs), _t(vv))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))

    lj, pj = jf.flood_fill(jnp.asarray(labels), jnp.asarray(probs),
                           jnp.asarray(vm))
    lt, pt = tf.flood_fill(_t(labels), _t(probs), _t(vm))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-6)


def test_preprocess_scan_filtered_matches_jax():
    jcfg = JConfig().small()
    jcfg = jcfg.replace(preprocess=dataclasses.replace(
        jcfg.preprocess, use_filtered_vertexmap=True))
    cfg = SumaConfig().small()
    cfg = cfg.replace(preprocess=dataclasses.replace(
        cfg.preprocess, use_filtered_vertexmap=True))
    scan, _ = _scan_maps()
    a = jpre(scan.points, scan.labels, scan.probs, scan.valid, True, jcfg)
    b = tpre(_t(scan.points), _t(scan.labels), _t(scan.probs),
             _t(scan.valid), True, cfg)
    for name in ("vertex_valid", "normal_valid", "sem_label"):
        np.testing.assert_array_equal(getattr(b, name).numpy(),
                                      np.asarray(getattr(a, name)), name)
    np.testing.assert_allclose(b.vertex.numpy(), np.asarray(a.vertex),
                               rtol=2e-5, atol=2e-5)
    # normals divide neighbour differences ~0.1 m apart: 2e-5 m vertex
    # differences can move them by ~2e-4
    np.testing.assert_allclose(b.normal.numpy(), np.asarray(a.normal),
                               atol=1e-3)
    np.testing.assert_allclose(b.sem_prob.numpy(), np.asarray(a.sem_prob),
                               atol=1e-6)
