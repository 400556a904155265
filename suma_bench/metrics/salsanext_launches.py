"""SalsaNext's launches a call: the CUDA API calls made inside the program's
span `segmenter/network` whose correlation id is a device operation's, over
the profiled scans (`spans.reduce`). Moves scans_per_s."""
from suma_bench.readers import span_row


def read(rec):
    row = span_row(rec, "segmenter/network")
    return None if row is None else row["launches"]
