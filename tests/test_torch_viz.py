"""The port's plots and viewer (``utils/viz``, ``utils/viz3d``) against the
JAX package's on the CPU.

* ``export_html`` writes the same bytes as JAX's for the same arrays, with
  and without subsampling.
* ``export_map_html`` of a port session and JAX's of the same state
  (converted by ``convert.slam_state_from_numpy``): the same page but for
  the surfel positions, which each package re-derives from the pose table
  (equal within 1e-5 m).
* The plot functions write the files JAX's write, by name, none empty, and
  take tensors as well as numpy arrays. The port draws them with numpy (no
  plotting library: the card's hosts have none), so only the names are
  compared; its PNG writer round-trips an image exactly through
  matplotlib's reader.
"""
import torch_env  # noqa: F401  (first: one torch thread)

import base64
import os
import re

import jax
import numpy as np
import torch

from semantic_suma_tpu.utils import viz as jviz
from semantic_suma_tpu.utils import viz3d as jviz3d
from semantic_suma_tpu_torch.utils import viz as tviz
from semantic_suma_tpu_torch.utils import viz3d as tviz3d


def _arrays(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.normal(0, 10, (n, 3)).astype(np.float32)
    col = rng.integers(0, 255, (n, 3)).astype(np.uint8)
    traj = np.tile(np.eye(4, dtype=np.float32), (9, 1, 1))
    traj[:, 0, 3] = np.arange(9)
    traj[:, 1, 3] = np.sin(np.arange(9))
    return pos, col, traj


def test_export_html_same_bytes_as_jax(tmp_path):
    pos, col, traj = _arrays()
    for kw in ({}, {"max_points": 500}):
        tviz3d.export_html(str(tmp_path / "t.html"), pos, col,
                           trajectory=traj, **kw)
        jviz3d.export_html(str(tmp_path / "j.html"), pos, col,
                           trajectory=traj, **kw)
        assert (tmp_path / "t.html").read_bytes() \
            == (tmp_path / "j.html").read_bytes()


def _blobs(path):
    return re.findall(r'decode\("([A-Za-z0-9+/=]*)"', open(path).read())


def test_export_map_html_matches_jax(tmp_path):
    from semantic_suma_tpu.config import SumaConfig as JConfig
    from semantic_suma_tpu.core import pipeline as jp
    from semantic_suma_tpu.io import simulation as jsim
    from semantic_suma_tpu_torch.config import SumaConfig
    from semantic_suma_tpu_torch.convert import slam_state_from_numpy
    jcfg = JConfig().small()
    reader = jsim.SimulationReader(jcfg.data, n_scans=2, radius=18.0)
    slam = jp.SurfelSLAM(jcfg, enable_loop_closure=False)
    for i in range(2):
        s = reader.read(i)
        slam.process_scan(s.points, s.labels, s.probs, s.valid)
    traj = np.stack(slam.poses)
    jviz3d.export_map_html(str(tmp_path / "j.html"), slam.state, jcfg.map,
                           trajectory=traj)
    state = slam_state_from_numpy(jax.tree.map(np.asarray, slam.state), "cpu")
    tviz3d.export_map_html(str(tmp_path / "t.html"), state,
                           SumaConfig().small().map, trajectory=traj)
    jb, tb = _blobs(tmp_path / "j.html"), _blobs(tmp_path / "t.html")
    assert len(jb) == len(tb) == 4
    assert tb[1:] == jb[1:]        # colours, trajectory, car glyph
    jpos, tpos = (np.frombuffer(base64.b64decode(b), np.float32)
                  for b in (jb[0], tb[0]))
    assert jpos.size > 3000
    np.testing.assert_allclose(tpos, jpos, rtol=0, atol=1e-5)
    strip = [re.sub(r'decode\("[A-Za-z0-9+/=]*"', "", open(p).read())
             for p in (tmp_path / "j.html", tmp_path / "t.html")]
    assert strip[0] == strip[1]


def _plot_all(viz, out, est, gt, stats, maps):
    os.makedirs(out)
    viz.plot_trajectory(est, gt, [2, 5], os.path.join(out, "traj.png"))
    viz.plot_statistics(stats, path=os.path.join(out, "stats.png"))
    by_len = {"100": {"t_rel_percent": 1.0, "r_rel_deg_per_100m": 0.5},
              "200": {"t_rel_percent": 1.2, "r_rel_deg_per_100m": 0.4}}
    viz.plot_error_breakdown(by_len, {}, path=os.path.join(out, "errors.png"))
    names = viz.save_map_images(maps, prefix=os.path.join(out, "model"))
    return sorted(os.path.basename(p) for p in names)


def test_plots_write_the_jax_files(tmp_path):
    from semantic_suma_tpu_torch.device import to_host
    from semantic_suma_tpu_torch.ops.icp import Maps
    rng = np.random.default_rng(1)
    _, _, est = _arrays()
    gt = est.copy()
    gt[:, 2, 3] += 0.1
    stats = [{"icp-iterations": int(k), "icp-error": float(e),
              "map-count": 100 * i, "complete-time": 0.01}
             for i, (k, e) in enumerate(zip(rng.integers(3, 9, 9),
                                            rng.random(9)))]
    h, w = 16, 90
    vertex = rng.normal(size=(h, w, 3)).astype(np.float32)
    normal = vertex / np.linalg.norm(vertex, axis=-1, keepdims=True)
    maps = Maps(torch.from_numpy(vertex), torch.from_numpy(normal),
                torch.from_numpy(rng.random((h, w)) < 0.9),
                torch.from_numpy(rng.random((h, w)) < 0.9),
                torch.from_numpy(rng.integers(0, 260, (h, w)).astype(
                    np.int32)),
                torch.from_numpy(rng.random((h, w)).astype(np.float32)))
    reads = to_host.count
    t_names = _plot_all(tviz, str(tmp_path / "t"), torch.from_numpy(est),
                        torch.from_numpy(gt), stats, maps)
    assert to_host.count > reads
    j_names = _plot_all(jviz, str(tmp_path / "j"), est, gt, stats,
                        jax.tree.map(lambda t: t.numpy(), maps))
    assert t_names == j_names == ["model_depth.png", "model_normals.png",
                                  "model_semantics.png"]
    t_files = sorted(os.listdir(tmp_path / "t"))
    assert t_files == sorted(os.listdir(tmp_path / "j"))
    assert len(t_files) == 6
    for f in t_files:
        assert os.path.getsize(tmp_path / "t" / f) > 0, f


def test_write_png_round_trips(tmp_path):
    import matplotlib.image
    img = np.random.default_rng(3).integers(0, 256, (37, 53, 3), np.uint8)
    tviz.write_png(str(tmp_path / "x.png"), img)
    back = matplotlib.image.imread(str(tmp_path / "x.png"))
    np.testing.assert_array_equal(np.rint(back * 255).astype(np.uint8), img)
