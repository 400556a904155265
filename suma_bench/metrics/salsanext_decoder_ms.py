"""SalsaNext's four up blocks and its head, ms of device time a call: the
union of the device operations launched inside the span
`segmenter/network/decoder` (`busy_ms`, `spans.reduce`), where the pixel
shuffles, the concatenations and the dilated branches run. Moves
scans_per_s."""
from suma_bench.readers import span_row


def read(rec):
    row = span_row(rec, "segmenter/network/decoder")
    return None if row is None else row["busy_ms"]
