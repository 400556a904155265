"""The port's spans and the benchmark's reading of them, on the CPU at
``SumaConfig().small()``.

* ``Stopwatch.span`` records its lap on the host clock and, while a
  ``torch.profiler`` records, is a ``record_function`` around its body; with
  no profiler recording no ``record_function`` is built at all, and a
  ``None`` stopwatch times nothing.
* A short ``SurfelSLAM`` session (spill and loop closer on, as the defaults
  have them) with a segmenter, traced on the CPU: one ``step`` a scan, its
  children nested as the step, ``fuse_and_render``, the host loop, the loop
  closer and the segmenter name them, each lap equal to its range's
  duration within 5% or 50 us; none of the names is one of the benchmark's
  own spans, and no ``host/`` label is new.
* ``host_ms_per_scan`` sums the same labels as before the spans (the host
  loop's ``dispatch`` and its ``host/*`` laps), with spill on and off.
* ``suma_bench/spans.py`` and the reader of ``flag_read_ms`` on a small
  hand-made Chrome trace: host, self, launches, busy and idle ms per scan;
  and a traced run of the runner on the CPU reduced into the span table.

CPU wall time: ~25 s on one worker."""

import torch_env  # noqa: F401  (first: one torch thread)

import gc
import json

import pytest
import torch

from semantic_suma_tpu_torch.config import MapConfig, SumaConfig
from semantic_suma_tpu_torch.core.pipeline import SurfelSLAM
from semantic_suma_tpu_torch.io.simulation import (circular_trajectory,
                                                   default_world, render_scan)
from semantic_suma_tpu_torch.models.segmenter import Segmenter
from semantic_suma_tpu_torch.utils import timing
from suma_bench import harness, readers, spans
from suma_bench.tests.small import small

N_SCANS = 5

# the spans a session and its segmenter open, each with the span it lies in
# (None: outermost among the program's)
PARENT = {
    "step": None, "step/preprocess": "step", "step/gauss_newton": "step",
    "step/flags": "step/gauss_newton", "step/fuse_render": "step",
    "fuse/refresh": "step/fuse_render", "fuse/update": "step/fuse_render",
    "fuse/create": "step/fuse_render", "fuse/render": "step/fuse_render",
    "step/pack": "step", "fetch-wait": None, "finish": None,
    "host/page-in": "finish", "host/spill-compact": "finish",
    "host/bookkeep": "finish", "loop": "finish", "loop/bookkeep": "loop",
    "loop/verify": "loop", "loop/edges": "loop", "loop/opt": "loop",
    "loop/search": "loop", "loop/compose": "loop",
    "segmenter/project": None, "segmenter/network": None,
    "segmenter/vote": None}
# the host loop's laps before the spans: the labels host_ms_per_scan sums
HOST_LAPS = ("host/page-in", "host/spill-probe", "host/spill-out",
             "host/spill-compact", "host/bookkeep")


@pytest.fixture(scope="module")
def scans():
    cfg = SumaConfig().small()
    world = default_world(0)
    poses = circular_trajectory(N_SCANS, radius=18.0, step=1.2)
    return [render_scan(world, p, cfg.data) for p in poses]


def _session(scans, cfg=None, segmenter=None):
    """Every scan through a pipelined session at depth 2, then a flush;
    returns the session."""
    cfg = SumaConfig().small() if cfg is None else cfg
    slam = SurfelSLAM(cfg, pipeline_depth=2, device="cpu")
    for s in scans:
        labels, probs = (s.labels, s.probs) if segmenter is None \
            else segmenter(s.points)
        slam.process_scan_async(s.points, labels, probs, s.valid)
    slam.flush()
    return slam


def _segmenter():
    torch.manual_seed(0)
    return Segmenter(SumaConfig().small().data, device="cpu")


def _ranges(path):
    with open(path) as f:
        events = json.load(f)
    events = events.get("traceEvents", events)
    return sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in events if e.get("ph") == "X"
                   and e.get("cat") == "user_annotation"),
                  key=lambda r: (r[0], -r[1]))


def _innermost_parent(rng, ranges):
    s, t, _ = rng
    around = [r for r in ranges if r is not rng and r[0] <= s and t <= r[1]]
    return min(around, key=lambda r: r[1] - r[0])[2] if around else None


class _Counted:
    """Stands in for ``record_function`` and counts its constructions."""

    made = 0

    def __init__(self, name, args=None):
        type(self).made += 1
        self._inner = _RECORD_FUNCTION(name, args)

    def __enter__(self):
        self._inner.__enter__()
        return self

    def __exit__(self, *exc):
        return self._inner.__exit__(*exc)


_RECORD_FUNCTION = torch.autograd.profiler.record_function


def test_span_records_its_lap_and_takes_a_new_label():
    sw = timing.Stopwatch()
    with sw.span("a"):
        pass
    with sw.span("b") as sp:
        sp.label = "c"
    assert sw.stats["a"].count == 1 and sw.stats["c"].count == 1
    assert "b" not in sw.stats
    # no stopwatch: nothing is timed, and a label may still be set
    with timing.span(None, "d") as sp:
        sp.label = "e"
    with timing.span(sw, "f"):
        pass
    assert set(sw.stats) == {"a", "c", "f"}


def test_no_record_function_without_a_profiler(monkeypatch, scans):
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _Counted)
    _Counted.made = 0
    seg = _segmenter()
    slam = _session(scans[:3], segmenter=seg)
    assert slam.stopwatch.stats["step"].count == 3
    assert seg.stopwatch.stats["segmenter/network"].count == 3
    assert _Counted.made == 0
    # the stand-in is the one a span builds while a profiler records
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with timing.Stopwatch().span("x"):
            pass
    assert _Counted.made == 1


def test_session_spans_nest_and_match_their_laps(monkeypatch, tmp_path,
                                                 scans):
    laps = {}   # label -> each lap, in the order the spans closed
    record = timing.Stopwatch.record

    def keep(self, label, elapsed):
        laps.setdefault(label, []).append(elapsed)
        record(self, label, elapsed)

    monkeypatch.setattr(timing.Stopwatch, "record", keep)
    seg = _segmenter()
    # a collection of this process's heap inside a lap but outside its range
    # would part the two by milliseconds
    gc.collect()
    gc.disable()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            slam = _session(scans, segmenter=seg)
    finally:
        gc.enable()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ranges = _ranges(path)
    names = {r[2] for r in ranges}
    assert names == set(PARENT)
    assert not names & set(harness.SPANS)
    assert {n for n in names if n.startswith("host/")} <= set(HOST_LAPS)
    for r in ranges:
        assert _innermost_parent(r, ranges) == PARENT[r[2]], r
    count = {n: sum(r[2] == n for r in ranges) for n in names}
    assert count["step"] == count["finish"] == N_SCANS
    assert count["segmenter/network"] == N_SCANS
    # the first scan's host part runs no loop phase
    assert count["loop"] == N_SCANS - 1
    assert slam.stopwatch.stats["step"].count == N_SCANS
    assert seg.stopwatch.stats["segmenter/network"].count == N_SCANS
    for n in names:
        durs = [(t - s) * 1e-6 for s, t, m in ranges if m == n]
        assert len(laps[n]) == len(durs), n
        gaps = sorted(lap - dur for lap, dur in zip(laps[n], durs))
        # the lap holds the range (to the clocks' rounding) ...
        assert gaps[0] >= -5e-6, n
        # ... and equals it within 5% or 50 us; the host's scheduler may
        # stretch one lap by milliseconds, so the middle one is held to it
        mid = gaps[len(gaps) // 2]
        assert mid <= max(0.05 * sorted(durs)[len(durs) // 2], 50e-6), n


@pytest.mark.parametrize("spill", [True, False])
def test_host_ms_per_scan_sums_the_same_labels(scans, spill):
    cfg = SumaConfig(map=MapConfig(spill_enabled=spill)).small()
    slam = _session(scans, cfg=cfg)
    laps = {k: v.total for k, v in slam.stopwatch.stats.items()}
    summed = {k for k in laps if k == "dispatch" or k.startswith("host/")}
    want = {"dispatch", "host/spill-compact", "host/bookkeep"}
    assert summed == (want | {"host/page-in"} if spill else want)
    rec = {"laps": laps, "scans": N_SCANS}
    got = readers.host_ms_per_scan(rec)
    assert got == pytest.approx(
        sum(laps[k] for k in summed) * 1e3 / N_SCANS, rel=1e-12)


def _x(name, ts, dur, cat="user_annotation", tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": 7, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _trace():
    """A traced window [0, 1000] us: one segmenter call and two steps.

    segmenter [0, 100]: segmenter/network [10, 90], launching kernel 1
    (corr 1, [30, 50] on the card). step 1 [100, 500]: step/preprocess [110,
    200] launches corr 2 (kernel [150, 250]) and corr 3 (a synchronize, no
    device operation); step/gauss_newton [200, 400] holds step/flags [300,
    380], which launches corr 4 (memcpy [310, 320]); step/fuse_render
    [400, 490] launches corr 5 (kernel [420, 440]) and corr 6 (kernel [430,
    470]). step 2 [600, 700]: step/fuse_render [600, 700], launching corr 7
    (kernel [650, 660]). A kernel outside the window and a launch on
    another thread are left out."""
    ev = [_x("traced", 0, 1000),
          _x("segmenter", 0, 100), _x("segmenter/network", 10, 80),
          _x("dispatch", 100, 500),
          _x("step", 100, 400), _x("step/preprocess", 110, 90),
          _x("step/gauss_newton", 200, 200), _x("step/flags", 300, 80),
          _x("step/fuse_render", 400, 90),
          _x("step", 600, 100), _x("step/fuse_render", 600, 100),
          _x("cudaLaunchKernel", 20, 5, "cuda_runtime", corr=1),
          _x("cudaLaunchKernel", 120, 5, "cuda_runtime", corr=2),
          _x("cudaStreamSynchronize", 130, 5, "cuda_runtime", corr=3),
          _x("cudaMemcpyAsync", 305, 5, "cuda_runtime", corr=4),
          _x("cuLaunchKernel", 410, 5, "cuda_driver", corr=5),
          _x("cudaLaunchKernel", 420, 5, "cuda_runtime", corr=6),
          _x("cudaLaunchKernel", 610, 5, "cuda_runtime", corr=7),
          _x("cudaLaunchKernel", 615, 5, "cuda_runtime", tid=2, corr=8),
          _x("k1", 30, 20, "kernel", corr=1), _x("k2", 150, 100, "kernel",
                                                   corr=2),
          _x("Memcpy DtoH", 310, 10, "gpu_memcpy", corr=4),
          _x("k5", 420, 20, "kernel", corr=5),
          _x("k6", 430, 40, "kernel", corr=6),
          _x("k7", 650, 10, "kernel", corr=7),
          _x("k8", 660, 5, "kernel", corr=8),
          _x("late", 2000, 10, "kernel", corr=9)]
    return ev


def test_spans_reduce_a_hand_made_trace():
    out = spans.reduce(_trace())
    assert (out["scans"], out["segmenter_calls"], out["device_ops"]) \
        == (2, 1, 7)
    t = out["spans"]
    assert set(t) == {"segmenter/network", "step", "step/preprocess",
                      "step/gauss_newton", "step/flags", "step/fuse_render"}
    # the device is busy over [30,50] [150,250] [310,320] [420,470]
    # [650,665]; per scan (two steps), in ms
    assert t["step"] == pytest.approx(
        {"count": 2, "host_ms": 0.25, "self_ms": 0.01, "launches": 2.5,
         "busy_ms": 0.085, "idle_ms": 0.1625})
    assert t["step/preprocess"] == pytest.approx(
        {"count": 1, "host_ms": 0.045, "self_ms": 0.045, "launches": 0.5,
         "busy_ms": 0.05, "idle_ms": 0.02})
    assert t["step/gauss_newton"] == pytest.approx(
        {"count": 1, "host_ms": 0.1, "self_ms": 0.06, "launches": 0.5,
         "busy_ms": 0.005, "idle_ms": 0.07})
    assert t["step/flags"] == pytest.approx(
        {"count": 1, "host_ms": 0.04, "self_ms": 0.04, "launches": 0.5,
         "busy_ms": 0.005, "idle_ms": 0.035})
    assert t["step/fuse_render"] == pytest.approx(
        {"count": 2, "host_ms": 0.095, "self_ms": 0.095, "launches": 1.5,
         "busy_ms": 0.03, "idle_ms": 0.0625})
    # per segmenter call (one)
    assert t["segmenter/network"] == pytest.approx(
        {"count": 1, "host_ms": 0.08, "self_ms": 0.08, "launches": 1.0,
         "busy_ms": 0.02, "idle_ms": 0.06})
    # the reader of the laps
    rec = {"laps": {"step/flags": 0.003}, "scans": 2}
    assert harness.reader("flag_read_ms").read(rec) == pytest.approx(1.5)


def test_readers_find_nothing_where_the_program_has_no_spans():
    # the window without the program's spans (a program that emits none),
    # or without a device operation (a CPU run), and no window at all
    bare = [e for e in _trace() if e["cat"] != "user_annotation"
            or e["name"] in harness.SPANS + ("traced",)]
    no_device = [e for e in _trace() if e["cat"] == "user_annotation"]
    assert spans.reduce(bare)["spans"] == {}
    assert spans.reduce(no_device)["device_ops"] == 0
    assert all(row["launches"] == row["busy_ms"] == 0.0
               for row in spans.reduce(no_device)["spans"].values())
    assert spans.reduce(_trace()[1:]) == {}
    # a session without the step's spans has no `step/flags` lap
    rec = {"laps": {"dispatch": 0.5, "host/bookkeep": 0.1}, "scans": 2}
    assert harness.reader("flag_read_ms").read(rec) is None


def test_traced_run_tables_the_profiled_scans():
    # a traced run of the runner on the CPU, with the trace it reduces
    # reduced once more into the span table
    plain = harness.reduce_trace
    over = small(6)
    result, table = spans.traced_run("suma-norevisit-offline", 2**31 + 11,
                                     0.1, device="cpu", overrides=over)
    assert harness.reduce_trace is plain
    a, b = over["traffic"]["trace_scans"]
    assert table["scans"] == b - a
    assert table["device_ops"] == 0
    rows = table["spans"]
    assert rows["step"]["count"] == b - a
    # the step's spans (the host loop finishes these scans after the
    # profiled ones, at its depth)
    assert {n for n in PARENT if n.startswith(("step", "fuse/"))} \
        <= set(rows)
    assert rows["step/flags"]["host_ms"] <= rows["step/gauss_newton"][
        "host_ms"] <= rows["step"]["host_ms"]
    assert result["metrics"]["flag_read_ms"]["value"] > 0.0
