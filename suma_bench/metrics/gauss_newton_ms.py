"""Gauss-Newton stage of `odometry_step`, ms a scan (`StageTimer`, CUDA
events: device-timeline time between stamps, waits on the host included).
Moves scans_per_s."""
from suma_bench.readers import stage_ms


def read(rec):
    return stage_ms(rec, "gauss_newton")
