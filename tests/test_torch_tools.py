"""The port's Gauss-Newton trace tool on the CPU at ``small()``: recording
changes no pose and counts the iterations ``SurfelSLAM`` reports, the recorder
puts back the functions it wrapped, and the period and stopping-test helpers
on made-up traces."""
import torch_env  # noqa: F401  (first: one torch thread)

import numpy as np
import torch

from semantic_suma_tpu_torch.config import (IcpConfig, LoopClosureConfig,
                                            MapConfig, PreprocessConfig,
                                            SumaConfig)
from semantic_suma_tpu_torch.core.pipeline import SurfelSLAM
from semantic_suma_tpu_torch.io.simulation import (circular_trajectory,
                                                   default_world, render_scan)
from semantic_suma_tpu_torch.ops import icp
from semantic_suma_tpu_torch.tools import gn_trace

N_SCANS = 5


def _cfg():
    return SumaConfig(map=MapConfig(spill_enabled=False),
                      loop=LoopClosureConfig(enabled=False),
                      preprocess=PreprocessConfig(use_filtered_vertexmap=True)
                      ).small()


def test_trace_run_changes_nothing_and_counts_iterations(capsys):
    cfg = _cfg()
    cpu = torch.device("cpu")
    wrapped = (icp.gauss_newton, icp.build_rows, icp._solve_spd)
    traced, counts, reasons = gn_trace.trace_run(cfg, N_SCANS, cpu)
    assert (icp.gauss_newton, icp.build_rows, icp._solve_spd) == wrapped

    world = default_world(seed=0, extent=45.0)
    gt = circular_trajectory(N_SCANS, radius=18.0, step=1.5, device=cpu)
    plain = SurfelSLAM(cfg, device=cpu)
    for i in range(N_SCANS):
        s = render_scan(world, gt[i], cfg.data)
        plain.process_scan(s.points, s.labels, s.probs, s.valid)
    np.testing.assert_array_equal(traced.trajectory(), plain.trajectory())
    assert counts == [s["icp-iterations"] for s in plain.statistics]
    assert len(reasons) == N_SCANS and set(reasons) <= {
        "step", "gradient", "error", "cap"}
    out = capsys.readouterr().out
    assert out.count("[gn] scan ") == N_SCANS


def test_period_of_a_tail():
    step = np.array([[1, 2, 3, 4, 5, 6.0]], np.float32) * 1e-4
    creep = np.tile(step, (33, 1))
    jump = creep.copy()
    jump[::2] *= -1
    noise = np.random.default_rng(0).normal(size=(33, 6)).astype(np.float32)
    assert gn_trace._period(creep) == 1
    assert gn_trace._period(jump) == 2
    assert gn_trace._period(noise) == 0


def test_stopping_test_of_a_trace():
    cfg = IcpConfig()
    # columns: error, inliers, |step|_inf, |max gradient|
    big = [10.0, 5, 1e-2, 1.0]
    assert gn_trace._stopped_by(np.array([big, [9.0, 5, 5e-5, 1.0]]),
                                cfg) == "step"
    assert gn_trace._stopped_by(np.array([big, [9.0, 5, 1e-2, 5e-5]]),
                                cfg) == "gradient"
    assert gn_trace._stopped_by(np.array([big, [10.0 - 5e-5, 5, 1e-2, 1.0]]),
                                cfg) == "error"
    assert gn_trace._stopped_by(np.array([big] * cfg.max_iterations),
                                cfg) == "cap"
