"""Host milliseconds a scan (host loop: the `Stopwatch` laps `dispatch` and
`host/*`, host clock, the wait for the fetch left out). Moves scans_per_s."""
from suma_bench.readers import host_ms_per_scan as read  # noqa: F401
