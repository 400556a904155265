"""Segmenter ms a scan: the benchmark's span around each
`Segmenter.__call__` (projection, network, kernel C's vote), timed by CUDA
events on the device's timeline, so the host's enqueueing of the network's
layers counts too (program_span, not a device trace). Moves scans_per_s."""


def read(rec):
    return rec.get("segmenter_ms")
