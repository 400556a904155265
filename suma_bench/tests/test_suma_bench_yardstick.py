"""The frozen yardstick against what it was copied from: kernel F's bytes
against PERF.md's bound, the trajectory errors and the generator against
the port's own copies. A network's FLOPs are held against PyTorch's count in
``test_suma_bench_nets.py``."""

import numpy as np
import pytest
import torch

from semantic_suma_tpu_torch.config import DataConfig
from semantic_suma_tpu_torch.io import simulation as port_sim
from semantic_suma_tpu_torch.utils import metrics as port_metrics
from suma_bench import generator, yardstick


def test_gn_bytes_are_perf_md_bound():
    assert yardstick.gn_call_bytes(64 * 900, 64 * 900) == 3_801_824


def _trajectory(rng, n):
    poses = np.repeat(np.eye(4)[None], n, axis=0)
    yaw = np.cumsum(rng.normal(0.0, 0.02, n))
    poses[:, 0, 0] = poses[:, 1, 1] = np.cos(yaw)
    poses[:, 0, 1], poses[:, 1, 0] = -np.sin(yaw), np.sin(yaw)
    poses[:, :3, 3] = np.cumsum(rng.normal(0.0, 1.5, (n, 3)), axis=0)
    return poses


@pytest.mark.parametrize("n", [2, 40, 150])
def test_trajectory_errors_match_the_port(n):
    rng = np.random.default_rng(n)
    gt = _trajectory(rng, n)
    est = gt.copy()
    est[:, :3, 3] += rng.normal(0.0, 0.05, (n, 3))
    ref = port_metrics.evaluate(gt, est)
    assert yardstick.ate_rmse(gt, est) == ref["ate_rmse_m"]
    assert yardstick.ate_rmse(gt, est, align=False) \
        == ref["ate_rmse_noalign_m"]
    t_rel, r_rel = yardstick.kitti_rel_errors(gt, est)
    np.testing.assert_allclose([t_rel, r_rel], [ref["t_rel_percent"],
                                                ref["r_rel_deg_per_100m"]],
                               rtol=1e-12, equal_nan=True)


@pytest.mark.parametrize("seed, movable", [(0, 0.0), (2**31 + 5, 0.3)])
def test_generator_matches_the_port(seed, movable):
    data = DataConfig(height=16, width=90)
    world = generator.default_world(seed, movable_fraction=movable)
    pw = port_sim.default_world(seed, movable_fraction=movable)
    assert [(b.center, b.size, b.label) for b in pw.boxes] \
        == [(b.center, b.size, b.label) for b in world.boxes]
    poses = generator.circular_trajectory(6, 18.0, step=1.8)
    torch.testing.assert_close(
        poses, port_sim.circular_trajectory(6, 18.0, step=1.8),
        rtol=0, atol=0)
    d = {"height": 16, "width": 90, "fov_up": 3.0, "fov_down": -25.0,
         "min_depth": 2.0, "max_depth": 75.0}
    gen = torch.Generator().manual_seed(3)
    ours = generator.render_scan(world, poses[3], d, 0.03, gen)
    gen = torch.Generator().manual_seed(3)
    theirs = port_sim.render_scan(pw, poses[3], data, 0.03, gen)
    for a, b in zip(ours, theirs):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_a_sequence_casts_the_sensors_rays_from_the_seed():
    traffic = {"world": {"extent": 45.0, "movable_fraction": 0.3},
               "trajectory": {"n": 3, "radius": 18.0, "step": 1.8}}
    data = {"height": 16, "width": 90, "fov_up": 3.0, "fov_down": -25.0,
            "min_depth": 2.0, "max_depth": 75.0}
    sensor = {"rings": 16, "columns": 200, "range_noise_m": 0.03}
    seed = 2**31 + 9
    a, gt = generator.render_sequence(traffic, data, sensor, seed, "cpu")
    b, _ = generator.render_sequence(traffic, data, sensor, seed, "cpu")
    c, _ = generator.render_sequence(traffic, data, sensor, seed + 1, "cpu")
    assert gt.shape == (3, 4, 4) and len(a) == 3
    assert a[0].points.shape == (16 * 200, 3)
    for x, y in zip(a[1], b[1]):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert not torch.equal(a[1].points, c[1].points)
    # the noise is the sensor's: ranges move by ~3 cm against a clean scan
    clean, _ = generator.render_sequence(
        traffic, data, dict(sensor, range_noise_m=0.0), seed, "cpu")
    v = a[1].valid & clean[1].valid
    dr = a[1].points[v].norm(dim=-1) - clean[1].points[v].norm(dim=-1)
    assert 0.025 < float(dr.std()) < 0.035
