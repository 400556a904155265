"""The port's segmenter (``models/labels``, ``models/rangenet``,
``models/segmenter``, ``convert.rangenet_state_from_flax``) against the JAX
package's on the CPU.

* The train-id tables: ``raw_to_train`` for every raw id 0..259 (and ids
  outside, clipped) and ``train_to_raw`` for every train id, exactly.
* Layout, in float32: flax ``RangeNet(dtype=float32)`` at ``small_rangenet``
  widths with random weights and batch statistics, against the port on the
  converted weights, at 2x16x96 and 1x16x90 (a width that needs the wrap
  pad): logits within 1e-4 relative to their largest magnitude. This pins
  the SAME padding, the unflipped transposed kernel and the names.
* The versioned weights in bfloat16 (both packages: bf16 convolutions with
  float32 sums, in other orders): ``segmenter_synth_mid.pkl`` at 32x180 and
  ``segmenter_synth_full.pkl`` at 16x96 (the 1-2-8-8-4 names), argmax
  agreement >= 99% of the valid pixels.
* ``Segmenter.__call__`` (KNN vote on and off) against the JAX
  ``Segmenter`` on a rendered scan: >= 99% equal labels, probabilities within
  0.05 (bf16 logits differ by up to ~0.07 between the two packages).
* Weight files: the port's ``save`` is read by the JAX ``Segmenter.load``
  and the JAX ``save`` by the port's, leaves exactly equal.
* The mIoU helpers, exactly; the datasets (``synthetic_dataset`` without
  noise, ``kitti_dataset``) against the JAX ones.
* A 10-scan ``small()`` run of the port's ``SurfelSLAM`` labelled by the mid
  network: more than 100 labelled points on scan 0, ATE < 0.5 m
  (``tests/test_segmenter.py``'s driven run).
"""
import torch_env  # noqa: F401  (first: one torch thread)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_suma_tpu.config import DataConfig as JData
from semantic_suma_tpu.io.simulation import default_world as jworld
from semantic_suma_tpu.io.simulation import render_scan as jrender
from semantic_suma_tpu.models import labels as jlab
from semantic_suma_tpu.models import rangenet as jrn
from semantic_suma_tpu.models import segmenter as jseg
from semantic_suma_tpu.ops.projection import project_scan as jproject
from semantic_suma_tpu_torch.config import DataConfig
from semantic_suma_tpu_torch.convert import (flax_variables_from_rangenet,
                                             rangenet_state_from_flax)
from semantic_suma_tpu_torch.models import labels as tlab
from semantic_suma_tpu_torch.models import rangenet as trn
from semantic_suma_tpu_torch.models import segmenter as tseg

MID = "weights/segmenter_synth_mid.pkl"
FULL = "weights/segmenter_synth_full.pkl"


def _leaves(tree, prefix=()):
    """{path: numpy leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_leaves(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def test_train_tables_match_jax():
    raw = np.arange(-3, 265, dtype=np.int32)
    np.testing.assert_array_equal(
        tlab.raw_to_train(torch.from_numpy(raw)).numpy(),
        np.asarray(jlab.raw_to_train(raw)))
    ids = np.arange(-2, 23, dtype=np.int32)
    np.testing.assert_array_equal(
        tlab.train_to_raw(torch.from_numpy(ids)).numpy(),
        np.asarray(jlab.train_to_raw(ids)))
    assert tlab.TRAIN_CLASSES == jlab.TRAIN_CLASSES


def _random_net(blocks, widths, dtype, seed):
    """A port ``RangeNet`` with random kernels (flax's initialisation) and
    random batch statistics and norm parameters, so that the comparison sees
    them."""
    net = trn.RangeNet(stage_blocks=blocks, widths=widths, dtype=dtype)
    net.reset_parameters(seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, trn.BatchNorm):
                for t, lo, hi in ((m.mean, -0.1, 0.1), (m.bias, -0.1, 0.1),
                                  (m.var, 0.5, 1.5), (m.scale, 0.5, 1.5)):
                    t.copy_(lo + (hi - lo) * torch.rand(t.shape,
                                                        generator=gen))
    return net


def _flax_apply(model, variables, x):
    """``model.apply`` of flax, compiled once (op by op it takes ~10x
    longer on the CPU)."""
    return np.asarray(jax.jit(lambda v, a: model.apply(v, a, train=False))(
        variables, jnp.asarray(x)))


@pytest.mark.parametrize("shape", [(2, 16, 96, 5), (1, 16, 90, 5)],
                         ids=["2x16x96", "1x16x90"])
def test_rangenet_f32_layout_matches_flax(shape):
    """Random weights made by the port, in flax's tree by
    ``flax_variables_from_rangenet``, run by flax; the port runs them after
    ``rangenet_state_from_flax`` of that tree, so both directions of the
    conversion are on the path."""
    widths, blocks = (16, 32, 64, 96, 128, 160), (1, 1, 2, 2, 1)
    variables = flax_variables_from_rangenet(
        _random_net(blocks, widths, torch.float32, 0).state_dict())
    x = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    want = _flax_apply(jrn.RangeNet(stage_blocks=blocks, widths=widths,
                                    dtype=jnp.float32), variables, x)
    net = trn.RangeNet(stage_blocks=blocks, widths=widths,
                       dtype=torch.float32)
    net.load_state_dict(rangenet_state_from_flax(variables))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == shape[:3] + (20,)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)
    # the names and layouts convert back to the same flax tree exactly
    back = _leaves(flax_variables_from_rangenet(net.state_dict()))
    orig = _leaves(variables)
    assert back.keys() == orig.keys()
    for k in orig:
        np.testing.assert_array_equal(back[k], orig[k])


def _scan(h, w, pose_x=18.0, movable=0.3):
    cfg = JData(height=h, width=w)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [pose_x, 0.0, 0.0]
    scan = jrender(jworld(0, movable_fraction=movable), jnp.asarray(pose),
                   cfg)
    return cfg, np.array(scan.points)


@pytest.fixture(scope="module")
def port_mid():
    return tseg.Segmenter.load(MID, DataConfig(height=32, width=180),
                               device="cpu")


@pytest.mark.parametrize("path,h,w", [(MID, 32, 180), (FULL, 16, 96)],
                         ids=["mid-32x180", "full-16x96"])
def test_real_weights_bf16_match_jax(path, h, w):
    cfg, pts = _scan(h, w)
    res = jproject(jnp.asarray(pts), cfg=cfg)
    x = np.asarray(jrn.make_input(res.vertex_map, res.depth_map,
                                  res.remission, res.vertex_valid))[None]
    js = jseg.Segmenter.load(path, cfg)
    want = _flax_apply(js.model, js.variables, x)[0]
    ts = tseg.Segmenter.load(path, DataConfig(height=h, width=w),
                             device="cpu")
    got = ts.logits(torch.tensor(x))[0].numpy()
    valid = np.asarray(res.vertex_valid)
    agree = (got.argmax(-1) == want.argmax(-1))[valid].mean()
    print(f"{path} at {h}x{w}: argmax agreement {agree:.5f} on "
          f"{valid.sum()} valid pixels, max |logit difference| "
          f"{np.abs(got - want).max():.4f} of |logits| up to "
          f"{np.abs(want).max():.1f}")
    assert agree >= 0.99
    assert ts.model.stage_blocks == js.model.stage_blocks


@pytest.mark.parametrize("use_knn", [True, False], ids=["knn", "no-knn"])
def test_segmenter_call_matches_jax(use_knn, port_mid):
    cfg, pts = _scan(32, 180, pose_x=16.0)
    # the JAX segmenter reads use_knn when its call is traced: one each
    jl, jp = (np.asarray(a) for a in
              jseg.Segmenter.load(MID, cfg, use_knn=use_knn)(pts))
    port_mid.use_knn = use_knn
    try:
        tl, tp = port_mid(pts)
    finally:
        port_mid.use_knn = True
    assert tl.dtype == torch.int32 and tl.shape == (pts.shape[0],)
    same = (tl.numpy() == jl).mean()
    print(f"use_knn={use_knn}: labels equal on {same:.5f} of the points, "
          f"max |probability difference| {np.abs(tp.numpy() - jp).max():.4f}")
    assert same >= 0.99
    np.testing.assert_allclose(tp.numpy(), jp, rtol=0, atol=0.05)
    assert int((tl > 0).sum()) > 100


def test_labels_for_points_on_the_scan_matches_jax(port_mid):
    """The reduction alone, on one network's logits of a scan."""
    from semantic_suma_tpu_torch.ops.knn import labels_for_points
    cfg, pts = _scan(32, 180)
    res = jproject(jnp.asarray(pts), cfg=cfg)
    x = np.asarray(jrn.make_input(res.vertex_map, res.depth_map,
                                  res.remission, res.vertex_valid))[None]
    logits = port_mid.logits(torch.tensor(x))[0].numpy()
    px = np.maximum(np.asarray(res.point_px), 0)
    py = np.maximum(np.asarray(res.point_py), 0)
    depth = np.linalg.norm(pts, axis=-1).astype(np.float32)
    valid = np.asarray(res.point_px) >= 0
    dmap = np.asarray(res.depth_map)
    jl, jp = jrn.labels_for_points(*(jnp.asarray(a) for a in
                                     (logits, px, py, depth, valid, dmap)))
    tl, tp = labels_for_points(*(torch.from_numpy(a) for a in
                                 (logits, px, py, depth, valid, dmap)))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-6)


def test_weight_files_cross_load(tmp_path, port_mid):
    # the port's file, read by the JAX package
    port = tseg.Segmenter(DataConfig(height=16, width=96), device="cpu",
                          rng_seed=3)
    path = str(tmp_path / "port.pkl")
    port.save(path, half=False)
    js = jseg.Segmenter.load(path, JData(height=16, width=96))
    assert js.model.widths == port.model.widths
    want = _leaves(flax_variables_from_rangenet(port.model.state_dict()))
    got = _leaves(jax.tree.map(np.asarray, js.variables))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    # the JAX package's half-precision file, read by the port
    path_h = str(tmp_path / "jax.pkl")
    js.save(path_h)
    ts = tseg.Segmenter.load(path_h, DataConfig(height=16, width=96),
                             device="cpu")
    import pickle
    with open(path_h, "rb") as f:
        stored = _leaves(pickle.load(f)["variables"])
    back = _leaves(flax_variables_from_rangenet(ts.model.state_dict()))
    assert back.keys() == stored.keys()
    for k in stored:
        assert back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], stored[k].astype(np.float32))
    # a round trip through the port's own half-precision file
    path_p = str(tmp_path / "mid.pkl")
    port_mid.save(path_p)
    again = tseg.Segmenter.load(path_p, DataConfig(height=32, width=180),
                                device="cpu")
    for k, v in port_mid.model.state_dict().items():
        assert torch.equal(again.model.state_dict()[k], v), k


def test_miou_helpers_match_jax():
    rng = np.random.default_rng(0)
    pred = rng.integers(0, 20, size=(3, 16, 90))
    gt = np.where(rng.uniform(size=pred.shape) < 0.7, pred,
                  rng.integers(0, 12, size=pred.shape))
    valid = rng.uniform(size=pred.shape) < 0.8
    cm = tseg.confusion_matrix(pred, gt, valid, 20)
    np.testing.assert_array_equal(cm, jseg.confusion_matrix(pred, gt, valid,
                                                            20))
    assert tseg.miou_from_confusion(cm) == jseg.miou_from_confusion(cm)
    np.testing.assert_array_equal(
        tseg.class_weights_from_freq(gt, valid, 20),
        jseg.class_weights_from_freq(gt, valid, 20))


def test_datasets_match_jax(tmp_path):
    """``synthetic_dataset`` without range noise (the poses are the same
    draws; only the noise generators differ) and ``kitti_dataset`` on an
    exported sequence: labels and masks equal on >= 99.9% of the pixels,
    network inputs within 1e-4 m + 1e-5 relative (the two simulators' rays
    differ by float32 ulps)."""
    from semantic_suma_tpu.io.kitti import KITTIReader as JReader
    from semantic_suma_tpu_torch.io.kitti import KITTIReader
    from semantic_suma_tpu_torch.io.kitti_export import \
        export_synthetic_sequence
    cfg = DataConfig(height=16, width=96)
    jcfg = JData(height=16, width=96)
    got = tseg.synthetic_dataset(cfg, 3, seed=0, noise_sigma=0.0,
                                 device="cpu")
    want = jseg.synthetic_dataset(jcfg, 3, seed=0, noise_sigma=0.0)
    seq = str(tmp_path / "seq")
    export_synthetic_sequence(seq, 2, cfg, step=1.0, device="cpu")
    got_k = tseg.kitti_dataset(KITTIReader(seq), cfg, [0, 1], device="cpu")
    want_k = jseg.kitti_dataset(JReader(seq), jcfg, [0, 1])
    for g, w in ((got, want), (got_k, want_k)):
        assert g[0].shape == w[0].shape and g[1].dtype == np.int32
        assert (g[1] == w[1]).mean() >= 0.999
        assert (g[2] == w[2]).mean() >= 0.999
        same = (g[2] == w[2])[..., None]
        np.testing.assert_allclose(np.where(same, g[0], 0),
                                   np.where(same, w[0], 0), rtol=1e-5,
                                   atol=1e-4)


def test_segmenter_drives_slam():
    from semantic_suma_tpu_torch.config import SumaConfig
    from semantic_suma_tpu_torch.core.pipeline import SurfelSLAM
    from semantic_suma_tpu_torch.io.simulation import (SimulationReader,
                                                       default_world)
    from semantic_suma_tpu_torch.utils.metrics import ate_rmse
    cfg = SumaConfig().small()
    seg = tseg.Segmenter.load(MID, cfg.data, device="cpu")
    n = 10
    reader = SimulationReader(cfg.data, n_scans=n, device="cpu", step=1.0,
                              world=default_world(0, movable_fraction=0.3))
    slam = SurfelSLAM(cfg, enable_loop_closure=False, device="cpu")
    for i in range(n):
        s = reader.read(i)
        labels, probs = seg(s.points)
        if i == 0:
            assert int((labels > 0).sum()) > 100
        slam.process_scan(s.points, labels, probs, s.valid)
    ate = ate_rmse(reader.poses.numpy().astype(np.float64),
                   slam.trajectory())
    assert ate < 0.5, ate
