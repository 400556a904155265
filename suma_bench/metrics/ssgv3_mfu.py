"""SqueezeSegV3-53's share of the card's bfloat16 peak while its operations
run, %: its forward FLOPs (`nets/squeezesegv3.py`, from the layer shapes;
994.3 GFLOP at 64x2048) over the device time of the operations launched
inside the span `segmenter/network` (`busy_ms` a call, `spans.reduce`; a
replayed graph keeps the span) and over 989 TFLOP/s. Moves scans_per_s."""
from suma_bench import yardstick
from suma_bench.readers import span_row


def read(rec):
    row = span_row(rec, "segmenter/network")
    flops = rec.get("flops_per_scan")
    if row is None or not flops or row["busy_ms"] <= 0.0:
        return None
    return 100.0 * flops / (row["busy_ms"] * 1e-3) \
        / yardstick.H100_BF16_FLOPS
