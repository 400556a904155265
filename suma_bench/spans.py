"""The program's own spans over the traced window, figure by figure.

The port names the parts of its work with ``torch.profiler`` ranges
(``utils/timing.Stopwatch.span``: ``step`` and its ``step/*`` and ``fuse/*``
children, ``finish`` and the host loop's ``host/*``, the segmenter's
``segmenter/*``), which land in the profiler's Chrome trace beside the
device's operations, on the same clock. :func:`reduce` gives, for each such
name, per scan:

* ``host_ms``: the spans' host time;
* ``self_ms``: the part of it that no span nested in it covers;
* ``launches``: CUDA runtime or CUDA driver API calls (``cuda_runtime``,
  ``cuda_driver``) made on the span's thread while it was open whose
  correlation id is that of a device operation in the trace;
* ``busy_ms``: the union of the device time of the operations those calls
  put on the card, wherever it ran;
* ``idle_ms``: the part of the span's interval that no device operation
  covers.

A scan is a ``step`` span; the ``segmenter/*`` names are per ``segmenter``,
the benchmark's span around each segmenter call. A program that emits no
span gives an empty table.

A traced run of the runner keeps the table in its record
(``record["spans"]``), where metric readers find it; its result line does not
carry it. To read it, run a cell traced through this module, which runs it
as ``run.py --trace 1`` does and reduces the same trace:

    python3 -m suma_bench.spans --workload <cell> --seed <n> --seconds <s>

Its last line of standard output is ``{"correct", "metrics", "spans"}``,
the ``[run]`` line on standard error as ``run.py`` prints it."""

from __future__ import annotations

import argparse
import json
import sys
from bisect import bisect_left, bisect_right
from collections import defaultdict
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from suma_bench import harness  # noqa: E402

LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
FIELDS = ("host_ms", "self_ms", "launches", "busy_ms", "idle_ms")


class _Cover:
    """The union of intervals, asked how much of ``[a, b]`` it covers."""

    def __init__(self, intervals):
        self.merged = harness._union(intervals)
        self.starts = [s for s, _ in self.merged]
        self.prefix = [0.0]
        for s, e in self.merged:
            self.prefix.append(self.prefix[-1] + (e - s))

    def total(self) -> float:
        return self.prefix[-1]

    def within(self, a: float, b: float) -> float:
        if b <= a or not self.merged:
            return 0.0
        i = max(bisect_right(self.starts, a) - 1, 0)
        j = bisect_left(self.starts, b)
        if j <= i:
            return 0.0
        whole = self.prefix[j] - self.prefix[i]
        # trim the first and the last merged interval to [a, b]
        s0, e0 = self.merged[i]
        whole -= max(0.0, min(a, e0) - s0)
        s1, e1 = self.merged[j - 1]
        whole -= max(0.0, e1 - max(b, s1))
        return max(0.0, whole)


def _complete(events, cats):
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in cats]


def reduce(events: list, window_name: str = "traced") -> dict:
    """The trace's program spans inside the window ``window_name``:
    ``{"scans": steps, "segmenter_calls": ..., "device_ops": ..., "spans":
    {name: {"count", "host_ms", "self_ms", "launches", "busy_ms",
    "idle_ms"}}}``, each figure per scan. Empty where the window is absent;
    ``spans`` empty where the program emitted none."""
    win = [e for e in _complete(events, ("user_annotation",))
           if e.get("name") == window_name]
    if not win:
        return {}
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])

    def inside(e):
        return w0 <= float(e["ts"]) and float(e["ts"]) < w1

    annotations = [e for e in _complete(events, ("user_annotation",))
                   if inside(e)]
    bench = defaultdict(int)
    spans = []   # (start, end, name, thread)
    for e in annotations:
        if e["name"] == window_name:
            continue
        if e["name"] in harness.SPANS:
            bench[e["name"]] += 1
            continue
        s = float(e["ts"])
        spans.append((s, s + float(e.get("dur", 0.0)), e["name"],
                      (e.get("pid"), e.get("tid"))))

    device = {}  # correlation id -> [(start, end)]
    intervals = []
    for e in _complete(events, harness.DEVICE_CATEGORIES):
        s = float(e["ts"])
        iv = (s, s + float(e.get("dur", 0.0)))
        corr = (e.get("args") or {}).get("correlation")
        if corr is not None:
            device.setdefault(corr, []).append(iv)
        if iv[1] > w0 and iv[0] < w1:
            intervals.append((max(iv[0], w0), min(iv[1], w1)))
    busy = _Cover(intervals)

    launches = defaultdict(list)  # thread -> sorted [(start, correlation)]
    for e in _complete(events, LAUNCH_CATEGORIES):
        corr = (e.get("args") or {}).get("correlation")
        if corr in device:
            launches[(e.get("pid"), e.get("tid"))].append(
                (float(e["ts"]), corr))
    for v in launches.values():
        v.sort()
    launch_ts = {k: [t for t, _ in v] for k, v in launches.items()}

    by_thread = defaultdict(list)
    for sp in spans:
        by_thread[sp[3]].append(sp)
    for v in by_thread.values():
        v.sort(key=lambda sp: (sp[0], -sp[1]))

    sums = defaultdict(lambda: dict.fromkeys(("count",) + FIELDS, 0.0))
    for thread, group in by_thread.items():
        for i, (s, t, name, _) in enumerate(group):
            children = []
            for s2, t2, _, _ in group[i + 1:]:
                if s2 >= t:
                    break
                if t2 <= t:
                    children.append((s2, t2))
            own = _Cover(children)
            lts = launch_ts.get(thread, [])
            lo, hi = bisect_left(lts, s), bisect_left(lts, t)
            ops = [iv for _, corr in launches[thread][lo:hi]
                   for iv in device[corr]]
            row = sums[name]
            row["count"] += 1
            row["host_ms"] += (t - s) * 1e-3
            row["self_ms"] += ((t - s) - own.total()) * 1e-3
            row["launches"] += hi - lo
            row["busy_ms"] += _Cover(ops).total() * 1e-3
            row["idle_ms"] += ((t - s) - busy.within(s, t)) * 1e-3

    steps = sum(1 for sp in spans if sp[2] == "step")
    calls = bench.get("segmenter", 0)
    table = {}
    for name, row in sorted(sums.items()):
        per = calls if name.startswith("segmenter/") else steps
        if not per:
            continue
        table[name] = {"count": int(row["count"]),
                       **{k: row[k] / per for k in FIELDS}}
    return {"scans": steps, "segmenter_calls": calls,
            "device_ops": len(intervals), "spans": table}


def traced_run(cell: str, seed: int, seconds: float, device: str = "cuda",
               overrides: dict | None = None):
    """``run.run_cell`` with tracing on, and the table :func:`reduce` gives
    of the trace that the run reduces (``{}`` where it profiled nothing)."""
    from suma_bench import run
    table: dict = {}
    plain = harness.reduce_trace

    def keep(events, *args, **kwargs):
        table.update(reduce(events, *args, **kwargs))
        return plain(events, *args, **kwargs)

    harness.reduce_trace = keep
    try:
        result = run.run_cell(cell, seed, seconds, True, device=device,
                              overrides=overrides)
    finally:
        harness.reduce_trace = plain
    return result, table


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="One traced run of a cell and its program spans.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("suma_bench.spans: needs a CUDA device", file=sys.stderr)
        return 3
    result, table = traced_run(args.workload, args.seed, args.seconds)
    print(f"[run] {json.dumps(result['_log'])}", file=sys.stderr)
    print(json.dumps({"correct": result["correct"],
                      "metrics": result["metrics"], "spans": table}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
