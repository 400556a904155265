"""The port's raycaster against the JAX one: points at atol 1e-4, labels and
valid flags exactly."""
import torch_env  # noqa: F401  (first: one torch thread)

import numpy as np
import pytest
import torch

from semantic_suma_tpu.config import DataConfig as JData
from semantic_suma_tpu.io import simulation as js
from semantic_suma_tpu_torch.config import DataConfig
from semantic_suma_tpu_torch.convert import world_from_numpy
from semantic_suma_tpu_torch.io import simulation as ts


@pytest.mark.parametrize("idx", [0, 7, 23])
def test_render_scan_matches_jax(idx):
    jworld = js.default_world(seed=0, extent=45.0)
    world = world_from_numpy(jworld.boxes, jworld.ground_z,
                             jworld.ground_label)
    assert world == ts.default_world(seed=0, extent=45.0)
    gt = np.asarray(js.circular_trajectory(40, radius=18.0, step=1.5))
    np.testing.assert_allclose(
        ts.circular_trajectory(40, radius=18.0, step=1.5).numpy(), gt)
    a = js.render_scan(jworld, gt[idx], JData(width=180, height=32))
    b = ts.render_scan(world, torch.from_numpy(gt[idx]),
                       DataConfig(width=180, height=32))
    np.testing.assert_array_equal(b.valid.numpy(), np.asarray(a.valid))
    np.testing.assert_array_equal(b.labels.numpy(), np.asarray(a.labels))
    np.testing.assert_allclose(b.points.numpy(), np.asarray(a.points),
                               atol=1e-4)
    np.testing.assert_allclose(b.probs.numpy(), np.asarray(a.probs))


def test_reader_requires_a_device():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError):
        ts.SimulationReader(DataConfig(width=180, height=32), n_scans=2)
    r = ts.SimulationReader(DataConfig(width=180, height=32), n_scans=2,
                            noise_sigma=0.02, device="cpu")
    a, b = r.read(1), r.read(1)
    assert torch.equal(a.points, b.points)  # noise is seeded per scan
