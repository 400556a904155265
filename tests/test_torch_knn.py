"""The segmenter's KNN post-processing (``ops/knn.py``) against the JAX
package's (``models/rangenet.py``) on the CPU.

* ``knn_clean_image`` (kernel C's wrapper, which runs its plain version on a
  CPU tensor) and the per-point ``knn_clean`` equal the JAX functions
  exactly, on class images with forced depth ties, +-inf and NaN ranges
  (centre and neighbour), an all-invalid row, the top and bottom edge rows
  and the wrap columns.
* ``labels_for_points`` in its three modes (image vote, point vote, no
  vote) on float32 logits: labels exactly equal, probabilities within
  1e-6 (two softmax implementations, float32).
* On a CPU tensor the wrapper launches nothing and counts nothing.
"""
import torch_env  # noqa: F401  (first: one torch thread)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_suma_tpu.models import rangenet as jrn
from semantic_suma_tpu_torch.ops import knn as tk


def _images(h, w, seed):
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, 6, size=(h, w)).astype(np.int32)
    depth = rng.uniform(5.0, 8.0, size=(h, w))
    depth = (np.round(depth * 4) / 4).astype(np.float32)   # forced ties
    m = rng.uniform(size=(h, w))
    depth[m < 0.08] = np.inf
    depth[(m >= 0.08) & (m < 0.12)] = np.nan
    depth[(m >= 0.12) & (m < 0.15)] = -np.inf
    depth[1] = np.inf                                       # invalid row
    # the wrap seam: near ranges and few classes on both sides
    depth[:, [0, 1, w - 2, w - 1]] = 6.0 + rng.integers(0, 3, (h, 4)) * 0.25
    cls[:, [0, 1, w - 2, w - 1]] = rng.integers(0, 2, (h, 4))
    return cls, depth


SHAPES = [(8, 12), (5, 7), (16, 90), (32, 180)]


@pytest.mark.parametrize("h,w", SHAPES, ids=[f"{h}x{w}" for h, w in SHAPES])
def test_knn_clean_image_matches_jax(h, w):
    cls, depth = _images(h, w, h * w)
    want = np.asarray(jrn.knn_clean_image(jnp.asarray(cls),
                                          jnp.asarray(depth)))
    launches = tk.knn_clean_image.launches
    got = tk.knn_clean_image(torch.from_numpy(cls), torch.from_numpy(depth))
    assert tk.knn_clean_image.launches == launches
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the vote changes labels, so the comparison is not of the input
    assert (want != cls).sum() > 0


@pytest.mark.parametrize("h,w", SHAPES[:3], ids=[f"{h}x{w}"
                                                 for h, w in SHAPES[:3]])
def test_knn_clean_point_matches_jax(h, w):
    cls, depth = _images(h, w, 7 + h)
    rng = np.random.default_rng(h + w)
    n = 400
    px = rng.integers(0, w, n).astype(np.int32)
    py = rng.integers(0, h, n).astype(np.int32)
    pd = (np.round(rng.uniform(5.0, 8.0, n) * 4) / 4).astype(np.float32)
    pd[:10], pd[10:20] = np.inf, np.nan
    pv = rng.uniform(size=n) < 0.9
    want = np.asarray(jrn.knn_clean(*(jnp.asarray(a) for a in
                                      (px, py, pd, pv, cls, depth))))
    got = tk.knn_clean(*(torch.from_numpy(a) for a in
                         (px, py, pd, pv, cls, depth)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_knn_clean_image_corner_cases():
    """A uniform image keeps its class; a centre with no kept neighbour
    keeps its own; a 2:2 tie goes to the nearer label."""
    cls = np.full((6, 9), 3, np.int32)
    depth = np.full((6, 9), 10.0, np.float32)
    cls[2, 4], depth[2, 4] = 7, 50.0            # isolated: keeps 7
    cls[4, 0], cls[4, 8] = 1, 1                 # across the seam
    got = tk.knn_clean_image(torch.from_numpy(cls), torch.from_numpy(depth))
    want = np.asarray(jrn.knn_clean_image(jnp.asarray(cls),
                                          jnp.asarray(depth)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[2, 4] == 7 and got[0, 0] == 3


@pytest.mark.parametrize("mode", ["image", "point", "none"])
def test_labels_for_points_matches_jax(mode):
    rng = np.random.default_rng(5)
    h, w, c, n = 16, 90, 20, 1500
    logits = rng.normal(size=(h, w, c)).astype(np.float32) * 3
    _, depth = _images(h, w, 11)
    px = rng.integers(0, w, n).astype(np.int32)
    py = rng.integers(0, h, n).astype(np.int32)
    pd = np.where(np.isfinite(depth[py, px]), depth[py, px], 6.0) \
        + rng.normal(0, 0.2, n)
    pd = pd.astype(np.float32)
    pv = rng.uniform(size=n) < 0.9
    kw = dict(use_knn=mode != "none",
              knn_mode="point" if mode == "point" else "image")
    jl, jp = jrn.labels_for_points(*(jnp.asarray(a) for a in
                                     (logits, px, py, pd, pv, depth)), **kw)
    tl, tp = tk.labels_for_points(*(torch.from_numpy(a) for a in
                                    (logits, px, py, pd, pv, depth)), **kw)
    assert tl.dtype == torch.int32 and tp.dtype == torch.float32
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-6)
    assert (tl.numpy()[~pv] == 0).all() and (tp.numpy()[~pv] == 0).all()


def test_wrapper_refuses_other_devices():
    cls = torch.zeros((4, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tk.knn_clean_image(cls, cls.float())
