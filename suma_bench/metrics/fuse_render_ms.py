"""Fusion and model render stage of `odometry_step`, ms a scan
(`StageTimer`). Moves scans_per_s."""
from suma_bench.readers import stage_ms


def read(rec):
    return stage_ms(rec, "fuse_render")
