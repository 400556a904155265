"""What the per-layer metric files (``metrics/<name>.py``) share: each reads
one quantity from the run's record. A reader that finds nothing to read
returns None, and the metric is left out of the result line.

The record (``run.run_cell``) holds, over the window: ``scans``,
``window_s``, ``host_reads`` (``device.to_host.count``), ``laps`` (the
sessions' ``Stopwatch`` totals in seconds, by label), ``stages``
(``StageTimer``'s mean ms by stage), ``segmenter_ms`` (the mean span of
a ``Segmenter`` call, by CUDA events), ``flops_per_scan`` (the network's forward), the
shapes of a Gauss-Newton call (``data_pixels``, ``model_cells``),
``trace``, the profiled scans reduced by ``harness.reduce_trace``, and
``spans``, the same trace reduced to the program's span table by
``spans.reduce`` (``{"scans", "segmenter_calls", "device_ops", "spans":
{name: row}}``, each row's figures per scan, ``segmenter/*`` per call)."""

from __future__ import annotations

from suma_bench import yardstick

# the kernels that implement a Gauss-Newton or ``evaluate`` call
GN_KERNELS = ("gn_loop_kernel",)


def host_reads_per_scan(rec):
    return rec["host_reads"] / rec["scans"]


def host_ms_per_scan(rec):
    laps = rec["laps"]
    if "dispatch" not in laps:
        return None
    host = laps["dispatch"] + sum(v for k, v in laps.items()
                                  if k.startswith("host/"))
    return host * 1e3 / rec["scans"]


def stage_ms(rec, stage):
    return rec.get("stages", {}).get(stage)


def gn_roofline(rec):
    """Kernel F's share of its bound: the bytes its calls need, each once,
    over HBM's rate, against the device time of the kernels that ran
    them."""
    trace = rec.get("trace")
    if not trace:
        return None
    calls, seconds = 0, 0.0
    for name, (count, s) in trace["ops"].items():
        if any(k in name for k in GN_KERNELS):
            calls += count
            seconds += s
    if not calls or seconds <= 0.0:
        return None
    need = calls * yardstick.gn_call_bytes(rec["data_pixels"],
                                           rec["model_cells"])
    return 100.0 * need / yardstick.H100_HBM_BYTES_PER_S / seconds


def device_idle_share(rec):
    trace = rec.get("trace")
    if not trace or trace["busy_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])


def span_row(rec, name):
    """The span table's row ``name``; None where the run traced no device
    operation or the program opened no such span."""
    table = rec.get("spans")
    if not table or not table["device_ops"]:
        return None
    return table["spans"].get(name)
