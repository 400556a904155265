"""SalsaNext's three context blocks, ms of device time a call: the union of
the device operations launched inside the span `segmenter/network/context`
(`busy_ms`, `spans.reduce`), the network's full-resolution part on 32
channels, bound by bandwidth. Moves scans_per_s."""
from suma_bench.readers import span_row


def read(rec):
    row = span_row(rec, "segmenter/network/context")
    return None if row is None else row["busy_ms"]
