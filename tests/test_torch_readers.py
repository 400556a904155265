"""The port's scan readers against the JAX package's, on files the tests
write (a sequence of ``export_synthetic_sequence`` and random scans; no
dataset is downloaded).

* ``io/native_io.NativeScanLoader`` (the port's copy of
  ``native/scan_loader.cpp``, built with ``g++``) equals the port's numpy
  ``read_bin`` and JAX's ``read_bin`` exactly, scans read in random order;
  ``KITTIReader(prefetch=True)`` equals ``prefetch=False`` exactly; a build
  without a compiler raises with the compiler's message, and the library
  reaches its name only through ``os.replace``.
* ``io/robocar.RobocarReader`` equals JAX's exactly on RobotCar ``.bin``
  files (three float64 a point).
"""
import torch_env  # noqa: F401  (first: one torch thread)

import os

import numpy as np
import pytest

from semantic_suma_tpu.io import kitti as jkitti
from semantic_suma_tpu.io.robocar import RobocarReader as JRobocar
from semantic_suma_tpu_torch.config import DataConfig
from semantic_suma_tpu_torch.io import kitti as tkitti
from semantic_suma_tpu_torch.io import native_io
from semantic_suma_tpu_torch.io.kitti_export import export_synthetic_sequence
from semantic_suma_tpu_torch.io.robocar import RobocarReader
from semantic_suma_tpu_torch.ops import cuda_build


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    """6 exported synthetic scans and 3 random scans with remissions."""
    root = tmp_path_factory.mktemp("seq") / "00"
    export_synthetic_sequence(str(root), 6, DataConfig(width=120, height=24),
                              step=1.0, device="cpu")
    rng = np.random.default_rng(0)
    for k in range(3):
        raw = rng.normal(0, 10, size=(1000 + 17 * k, 4)).astype(np.float32)
        raw[:, 3] = rng.uniform(0, 0.7, raw.shape[0])
        raw.tofile(root / "velodyne" / f"{900 + k:06d}.bin")
    return root


def _files(root):
    vel = root / "velodyne"
    return sorted(str(vel / f) for f in os.listdir(vel))


def test_native_loader_equals_numpy_and_jax_in_random_order(seq):
    files = _files(seq)
    loader = native_io.NativeScanLoader(files)
    order = np.random.default_rng(1).permutation(np.repeat(
        np.arange(len(files)), 2))
    try:
        for i in order:
            pts, rem = loader.read(int(i))
            for want in (tkitti.read_bin(files[i]),
                         jkitti.read_bin(files[i])):
                np.testing.assert_array_equal(pts, want[0])
                np.testing.assert_array_equal(rem, want[1])
                assert pts.dtype == want[0].dtype == np.float32
    finally:
        loader.close()


def test_kitti_reader_prefetch_equals_numpy(seq):
    fast = tkitti.KITTIReader(str(seq), prefetch=True)
    slow = tkitti.KITTIReader(str(seq), prefetch=False)
    assert fast._native is not None and slow._native is None
    assert fast.count() == slow.count() == 9
    for i in (8, 0, 3, 3, 5, 1):
        a, b = fast.read(i), slow.read(i)
        for f in a._fields:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)


def test_build_writes_through_a_temporary_name(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "BUILD", tmp_path)
    lib = native_io.build()
    assert lib == tmp_path / "libscan_loader.so" and lib.is_file()
    assert [p.name for p in tmp_path.iterdir()] == ["libscan_loader.so"]
    assert native_io.build() == lib  # up to date: not rebuilt


def test_missing_compiler_raises(tmp_path, monkeypatch, seq):
    monkeypatch.setattr(cuda_build, "BUILD", tmp_path / "empty")
    monkeypatch.setattr(native_io, "_lib", None)
    monkeypatch.setenv("PATH", str(tmp_path))  # no g++ on it
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native_io.build()
    # the reader does not fall back to numpy when the build fails
    with pytest.raises(RuntimeError, match="scan loader"):
        tkitti.KITTIReader(str(seq), prefetch=True)
    assert tkitti.KITTIReader(str(seq), prefetch=False).count() == 9


def test_robocar_reader_equals_jax(seq, tmp_path):
    files = _files(seq)
    for k, f in enumerate(files[:4]):
        pts = tkitti.read_bin(f)[0].astype(np.float64)
        pts.tofile(tmp_path / f"{k:04d}.bin")
    (tmp_path / "notes.txt").write_text("not a scan")
    ours, theirs = RobocarReader(str(tmp_path)), JRobocar(str(tmp_path))
    assert ours.count() == theirs.count() == 4 and ours.is_seekable()
    for i in range(4):
        a, b = ours.read(i), theirs.read(i)
        for f in a._fields:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
        want = tkitti.read_bin(files[i])[0] * np.float32([1, -1, -1])
        np.testing.assert_array_equal(a.points, want)
        assert (a.remissions == 0).all() and (a.labels == 0).all()
        assert (a.probs == 1).all()
    with pytest.raises(FileNotFoundError):
        RobocarReader(str(seq))
