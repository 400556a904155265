"""Host reads a scan (host loop: `device.to_host.count` over the window's
scans, every wait of the host for the device). Moves scans_per_s."""
from suma_bench.readers import host_reads_per_scan as read  # noqa: F401
