"""The whole step's share of the card's bfloat16 peak in the SqueezeSegV3-53
cell, %: the network's forward FLOPs from its layer shapes
(`nets/squeezesegv3.py`), times the window's scans, over the window's time
(host clock) and over 989 TFLOP/s; SLAM's own FLOPs are left out (under 0.1
GFLOP a scan, against 994.3 for SqueezeSegV3-53 at 64x2048). Moves
scans_per_s."""
from suma_bench import yardstick


def read(rec):
    flops = rec.get("flops_per_scan")
    if not flops:
        return None
    return 100.0 * flops * rec["scans"] / rec["window_s"] \
        / yardstick.H100_BF16_FLOPS
