"""The SAC kernel's share of its roofline, %: the bytes its calls need, each
once (`nets/squeezesegv3.py`'s `sac_bytes` of the configuration's segmenter
group, 159.4 MB a call at 64x2048, 23 calls a forward), over 3.35 TB/s,
against the device time of the `sac_kernel` rows of the trace
(`csrc/sac.cu`). Nothing where no such kernel ran. Moves scans_per_s."""
from suma_bench import harness, yardstick

CONFIG = "sumapp-ssgv3-53"
KERNEL = "sac_kernel"


def read(rec):
    trace = rec.get("trace")
    if not trace:
        return None
    calls, seconds = 0, 0.0
    for name, (count, s) in trace["ops"].items():
        if KERNEL in name:
            calls += count
            seconds += s
    if not calls or seconds <= 0.0:
        return None
    seg = harness.load_json(harness.HERE / "configs"
                            / f"{CONFIG}.json")["segmenter"]
    per_call = harness.net(seg["arch"]).sac_bytes(seg) \
        / sum(seg["stage_blocks"])
    return 100.0 * calls * per_call / yardstick.H100_HBM_BYTES_PER_S / seconds
