"""The device's idle share, %: 1 - the union of device operations over the
profiled scans. Moves scans_per_s."""
from suma_bench.readers import device_idle_share as read  # noqa: F401
