"""Kernel F's share of its roofline, %: each Gauss-Newton call's bytes
(`yardstick.gn_call_bytes`, each once) over 3.35 TB/s, against the device
time of `gn_loop_kernel` in the trace. Moves scans_per_s."""
from suma_bench.readers import gn_roofline as read  # noqa: F401
