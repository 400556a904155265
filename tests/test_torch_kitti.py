"""The port's KITTI I/O (``io/kitti.py``, ``io/kitti_export.py``) against
the JAX package's on the CPU.

* ``.bin``, ``.label``, ``calib.txt`` and pose files written by the port
  read back exactly, by the port's readers and by the JAX package's; poses
  through the camera-frame convention ``Tr @ P @ Tr^-1`` within 1e-9
  relative (ten significant digits in the file).
* A sequence written by the port's ``export_synthetic_sequence`` and read
  by the JAX ``KITTIReader``: labels, calibration and ground-truth poses
  exactly equal to those of the JAX package's own export of the same
  sequence, points within 1e-4 m + 1e-5 of their coordinate (the two
  simulators' rays differ by a few float32 ulps; far along a grazing ray
  that reaches 1.75e-4 m at 4.6e-6 relative, on 5 of 7,530 coordinates
  of this sequence). The port's reader gives the JAX reader's
  scans exactly on either directory.
* The file path end to end at 24x120: ``cli run --dataset`` exports poses
  whose ``cli eval`` (with the calibration) gives ``run --eval``'s ATE
  within 1e-6 m.
"""
import torch_env  # noqa: F401  (first: one torch thread)

import contextlib
import io
import json

import numpy as np
import pytest

from semantic_suma_tpu.config import DataConfig as JData
from semantic_suma_tpu.io import kitti as jk
from semantic_suma_tpu.io import kitti_export as jke
from semantic_suma_tpu_torch import cli as tcli
from semantic_suma_tpu_torch.config import DataConfig
from semantic_suma_tpu_torch.io import kitti as tk
from semantic_suma_tpu_torch.io import kitti_export as tke

N = 4


def test_bin_and_label_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(500, 3)).astype(np.float32) * 20
    rem = rng.uniform(0.0, 0.7, size=500).astype(np.float32)
    lab = rng.choice([0, 10, 40, 50, 252], size=500)
    valid = rng.uniform(size=500) < 0.8
    tke.export_scan(str(tmp_path / "a.bin"), str(tmp_path / "a.label"),
                    pts, rem, lab, valid)
    got_p, got_r = tk.read_bin(str(tmp_path / "a.bin"))
    np.testing.assert_array_equal(got_p, pts[valid])
    np.testing.assert_array_equal(got_r, rem[valid] / rem[valid].max())
    np.testing.assert_array_equal(tk.read_label(str(tmp_path / "a.label")),
                                  lab[valid])
    jp_, jr = jk.read_bin(str(tmp_path / "a.bin"))
    np.testing.assert_array_equal(jp_, got_p)
    np.testing.assert_array_equal(jr, got_r)
    np.testing.assert_array_equal(jk.read_label(str(tmp_path / "a.label")),
                                  lab[valid])
    # the instance id in the high 16 bits is dropped
    (np.array([50 | (7 << 16)], np.uint32)).tofile(tmp_path / "b.label")
    assert tk.read_label(str(tmp_path / "b.label")).tolist() == [50]


def test_calib_and_poses_round_trip(tmp_path):
    tke.write_calib(str(tmp_path / "calib.txt"))
    calib = tk.parse_calib(str(tmp_path / "calib.txt"))
    jcalib = jk.parse_calib(str(tmp_path / "calib.txt"))
    assert set(calib) == set(jcalib) == {"P0", "P1", "P2", "P3", "Tr"}
    for k in calib:
        np.testing.assert_array_equal(calib[k], jcalib[k])
    np.testing.assert_array_equal(calib["Tr"], tke.DEFAULT_TR)
    np.testing.assert_array_equal(tke.DEFAULT_TR, jke.DEFAULT_TR)

    rng = np.random.default_rng(1)
    poses = np.tile(np.eye(4), (6, 1, 1))
    for p in poses:
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        p[:3, :3] = q * np.sign(np.linalg.det(q))
        p[:3, 3] = rng.normal(size=3) * 30
    tr = calib["Tr"]
    tk.save_poses(str(tmp_path / "p.txt"), poses, tr)
    jk.save_poses(str(tmp_path / "jp.txt"), poses, tr)
    assert (tmp_path / "p.txt").read_text() == (tmp_path / "jp.txt").read_text()
    np.testing.assert_allclose(tk.load_poses(str(tmp_path / "p.txt"), tr),
                               poses, rtol=1e-9, atol=1e-9)
    np.testing.assert_array_equal(
        tk.load_poses(str(tmp_path / "p.txt"), tr),
        jk.load_poses(str(tmp_path / "p.txt"), tr))


@pytest.fixture(scope="module")
def sequences(tmp_path_factory):
    """The same 4-scan 24x120 sequence exported by each package."""
    root = tmp_path_factory.mktemp("kitti")
    gt = tke.export_synthetic_sequence(
        str(root / "port"), N, DataConfig(width=120, height=24), step=1.0,
        device="cpu")
    jgt = jke.export_synthetic_sequence(
        str(root / "jax"), N, JData(width=120, height=24), step=1.0)
    return root, gt, jgt


def test_port_export_read_by_the_jax_reader(sequences):
    root, gt, jgt = sequences
    np.testing.assert_allclose(gt, np.asarray(jgt, np.float64), rtol=0,
                               atol=1e-12)
    port = jk.KITTIReader(str(root / "port"), prefetch=False)
    ref = jk.KITTIReader(str(root / "jax"), prefetch=False)
    assert port.count() == ref.count() == N
    np.testing.assert_array_equal(port.gt_poses(), ref.gt_poses())
    for k in ref.calib:
        np.testing.assert_array_equal(port.calib[k], ref.calib[k])
    for i in range(N):
        a, b = port.read(i), ref.read(i)
        assert a.points.shape == b.points.shape
        np.testing.assert_array_equal(a.labels, b.labels)
        np.testing.assert_array_equal(a.probs, b.probs)
        np.testing.assert_array_equal(a.remissions, b.remissions)
        np.testing.assert_allclose(a.points, b.points, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("which", ["port", "jax"])
def test_port_reader_equals_the_jax_reader(sequences, which):
    root, _, _ = sequences
    got = tk.KITTIReader(str(root / which))
    want = jk.KITTIReader(str(root / which), prefetch=False)
    assert got.count() == want.count()
    np.testing.assert_array_equal(got.tr, want.tr)
    np.testing.assert_array_equal(got.gt_poses(), want.gt_poses())
    for i in range(N):
        for a, b in zip(got.read(i), want.read(i)):
            np.testing.assert_array_equal(a, b)
    # without labels: geometry only
    bare = tk.KITTIReader(str(root / which), use_gt_labels=False)
    s = bare.read(0)
    assert (s.labels == 0).all() and (s.probs == 1).all()


def test_reader_takes_a_segmenter_callable(sequences):
    root, _, _ = sequences

    def segmenter(points, remissions):
        return np.full(len(points), 10), np.full(len(points), 0.5)

    s = tk.KITTIReader(str(root / "port"), segmenter=segmenter,
                       use_gt_labels=False).read(1)
    assert (s.labels == 10).all() and np.allclose(s.probs, 0.5)
    assert s.labels.dtype == np.int32 and s.probs.dtype == np.float32


XML = """<config>
<param name="data_width" type="integer">120</param>
<param name="data_height" type="integer">24</param>
<param name="model_width" type="integer">120</param>
<param name="model_height" type="integer">24</param>
<param name="max iterations" type="integer">8</param>
</config>
"""


def _eval_json(text):
    return json.loads(text[text.index("\n{") + 1:])


def test_cli_dataset_run_and_eval_agree(sequences, tmp_path):
    root, _, _ = sequences
    seq = root / "port"
    (tmp_path / "cfg.xml").write_text(XML)
    est = tmp_path / "est.txt"
    outs = []
    for argv in (["--cpu", "run", "--dataset", str(seq), "--config",
                  str(tmp_path / "cfg.xml"), "--no-loop-closure",
                  "--surfel-capacity", str(1 << 15), "--active-capacity",
                  str(1 << 13), "--export-poses", str(est), "--eval"],
                 ["eval", "--gt", str(seq / "poses.txt"), "--est", str(est),
                  "--calib", str(seq / "calib.txt")]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert tcli.main(argv) == 0
        outs.append(_eval_json("\n" + buf.getvalue()))
    run, ev = outs
    assert abs(run["ate_rmse_m"] - ev["ate_rmse_m"]) <= 1e-6
    assert run["ate_rmse_m"] < 0.05
    # the exported file is in the camera frame of the calibration
    tr = tk.parse_calib(str(seq / "calib.txt"))["Tr"]
    assert not np.allclose(tk.load_poses(str(est)), tk.load_poses(str(est),
                                                                  tr))
