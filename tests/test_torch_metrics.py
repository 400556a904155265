"""The port's devkit evaluation against the JAX package's: ``evaluate``
with the per-length and per-speed tables, on seeded random and circular
trajectories, equal within rtol 1e-12 (both are float64 numpy; NaNs where
a trajectory is too short for a segment compare equal)."""
import torch_env  # noqa: F401  (first: one torch thread)

import math

import numpy as np
import pytest

from semantic_suma_tpu.io.simulation import circular_trajectory
from semantic_suma_tpu.utils import metrics as jm
from semantic_suma_tpu_torch.utils import metrics as tm


def _se3(rng, scale_t, scale_r):
    from scipy.spatial.transform import Rotation
    m = np.eye(4)
    m[:3, :3] = Rotation.from_rotvec(rng.normal(0, scale_r, 3)).as_matrix()
    m[:3, 3] = rng.normal(0, scale_t, 3)
    return m


def _random_walk(n, seed):
    """Ground truth: a forward walk at 1 to 3 m per frame with heading
    changes; estimate: the ground truth with compounding noise."""
    rng = np.random.default_rng(seed)
    gt, est = [np.eye(4)], [np.eye(4)]
    for _ in range(n - 1):
        step = _se3(rng, 0.05, 0.02)
        step[0, 3] += rng.uniform(1.0, 3.0)
        gt.append(gt[-1] @ step)
        est.append(est[-1] @ step @ _se3(rng, 0.01, 0.002))
    return np.stack(gt), np.stack(est)


def _circle(n, seed):
    gt = np.asarray(circular_trajectory(n, radius=18.0, step=1.5),
                    np.float64)
    rng = np.random.default_rng(seed)
    est = np.stack([g @ _se3(rng, 0.02, 0.001) for g in gt])
    return gt, est


def _close(a, b, path="res"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, float) and math.isnan(a):
        assert math.isnan(b), path
    elif isinstance(a, int):
        assert a == b, path
    else:
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0, err_msg=path)


@pytest.mark.parametrize("make,n,seed", [(_random_walk, 400, 0),
                                         (_random_walk, 150, 1),
                                         (_circle, 150, 2),
                                         (_circle, 40, 3)])
def test_evaluate_matches_jax(make, n, seed):
    gt, est = make(n, seed)
    got = tm.evaluate(gt, est, breakdown=True)
    want = jm.evaluate(gt, est, breakdown=True)
    _close(got, want)
    assert got.keys() == want.keys()
    if n >= 150:
        assert got["num_segments"] > 0 and got["by_length"] \
            and got["by_speed"]


def test_error_tables_match_jax():
    gt, est = _random_walk(400, 4)
    errors_t = tm.calc_sequence_errors(gt, est)
    errors_j = jm.calc_sequence_errors(gt, est)
    _close(tm.average_errors(errors_t), jm.average_errors(errors_j))
    _close(tm.errors_by_length(errors_t), jm.errors_by_length(errors_j))
    for bin_mps in (1.0, 2.0, 5.0):
        _close(tm.errors_by_speed(errors_t, bin_mps),
               jm.errors_by_speed(errors_j, bin_mps))
    assert tm.average_errors([]) != tm.average_errors([])  # NaN pair
    assert tm.errors_by_speed([]) == jm.errors_by_speed([]) == {}
