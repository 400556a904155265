"""Run one cell of the benchmark once and print its result line.

    python3 -m suma_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up renders the traffic mix's sequence from the seed onto the card (the
benchmark's frozen generator), loads the network where the configuration
has one, and warms every path up on a short session. The window then
replays the sequence, a fresh ``SurfelSLAM`` session each time as a new
recording would get, until ``--seconds`` have passed; the sequence in flight
then runs to its end and the window ends with it, so every rate counts whole
sequences. ``--trace 1`` reads the per-layer metrics instead of the
end-to-end ones: the program's counters and laps over the window, and a
profiler trace over a few scans of its first sequence.

Once the window has closed, the plain reference (``reference/``) works the
sequence out again and the run is ``correct`` when every number compared
lies within its limit (``limits/<cell>.json``). The last line of standard
output is the result; the numbers compared, each beside its limit, are the
last lines of standard error."""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import weakref  # noqa: E402
from contextlib import nullcontext  # noqa: E402
from pathlib import Path  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from suma_bench import generator, harness, spans, yardstick  # noqa: E402

GIB = float(1 << 30)


def _set_caches() -> None:
    """Every build and kernel cache at a fixed directory inside the
    checkout; no library of the port may load JAX."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(harness.CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def port_config(sections: dict):
    """The port's ``SumaConfig`` from a config file's ``suma`` group."""
    from semantic_suma_tpu_torch import config as pc
    kinds = {"data": pc.DataConfig, "model": pc.DataConfig,
             "icp": pc.IcpConfig, "map": pc.MapConfig,
             "loop": pc.LoopClosureConfig,
             "preprocess": pc.PreprocessConfig,
             "semantic": pc.SemanticConfig}
    return pc.SumaConfig(**{k: (kinds[k](**v) if k in kinds else v)
                            for k, v in sections.items()})


class Replay:
    """Drives sequences through the port as the traffic mix says, and keeps
    what the readers and the check need."""

    def __init__(self, cfg, traffic, dev, seg, trace: bool):
        import torch
        from semantic_suma_tpu_torch.core.pipeline import StageTimer
        self.torch = torch
        self.cfg = cfg
        self.mode = traffic["mode"]
        self.depth = int(traffic["pipeline_depth"])
        self.period = 1.0 / float(traffic.get("rate_hz", 10.0))
        self.dev = dev
        self.seg = seg
        self.trace = trace
        self.timer = StageTimer() if trace else None
        self.seg_events: list = []
        self.laps: dict = {}
        self.counts = {"closures": 0, "optimizations": 0, "rebases": 0,
                       "soft_integrations": 0, "creations_dropped": 0,
                       "collections": 0}
        self.latencies: list = []
        self.lateness: list = []
        self.captured: dict = {}   # scan index -> (logits, labels)
        self.profile = None
        if trace:
            from torch.profiler import record_function
            self.span = record_function
        else:
            self.span = lambda name: nullcontext()

    def _labels(self, scan, k: int, capture: bool):
        if self.seg is None:
            return scan.labels, scan.probs
        torch = self.torch
        with self.span("segmenter"):
            hook = None
            if capture:
                box = {}

                def keep(module, inputs, out):
                    box["logits"] = out[0].detach().clone()

                hook = self.seg.net.register_forward_hook(keep)
            ev = None
            if self.trace and self.dev.type == "cuda":
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            labels, probs = self.seg(scan.points)
            if ev is not None:
                ev[1].record()
                self.seg_events.append(ev)
            if hook is not None:
                hook.remove()
                self.captured[k] = (box["logits"], labels.clone())
        return labels, probs

    def sequence(self, scans, t_due0=None, k0: int = 0, capture=(),
                 profile_scans=None):
        """One session over ``scans``; returns its trajectory (numpy) and
        the global index of the next scan. ``t_due0`` paces the scans open
        loop (online mode): scan ``k0 + i`` is due at ``t_due0 + (k0 + i) *
        period``."""
        from semantic_suma_tpu_torch.core.pipeline import SurfelSLAM
        with self.span("session"):
            slam = SurfelSLAM(self.cfg, pipeline_depth=self.depth,
                              device=self.dev)
            slam.timer = self.timer
        k = k0
        try:
            for i, scan in enumerate(scans):
                if profile_scans is not None and i == profile_scans[0]:
                    self._start_profile()
                if t_due0 is not None:
                    due = t_due0 + k * self.period
                    with self.span("wait"):
                        # sleep to within 2 ms of the due time, then spin:
                        # a late wake-up would count as the system's latency
                        while True:
                            now = time.perf_counter()
                            if now >= due:
                                break
                            if due - now > 0.002:
                                time.sleep(due - now - 0.002)
                    self.lateness.append(now - due)
                labels, probs = self._labels(scan, i, i in capture)
                with self.span("dispatch"):
                    if self.mode == "online":
                        slam.process_scan(scan.points, labels, probs,
                                          scan.valid)
                    else:
                        slam.process_scan_async(scan.points, labels, probs,
                                                scan.valid)
                if t_due0 is not None:
                    self.latencies.append(time.perf_counter() - due)
                k += 1
                if profile_scans is not None and i + 1 == profile_scans[1] \
                        and self.profile is not None:
                    self._stop_profile()
            if self.profile is not None and not hasattr(self, "_traced_s"):
                self._stop_profile()
            with self.span("drain"):
                slam.flush()
            with self.span("finalize"):
                slam.finalize()
            traj = slam.trajectory()
            for label, st in slam.stopwatch.stats.items():
                self.laps[label] = self.laps.get(label, 0.0) + st.total
            lp = slam._loop
            if lp is not None:
                self.counts["closures"] += lp.num_loop_closures
                self.counts["optimizations"] += lp.num_optimizations
                self.counts["rebases"] += lp.num_rebases
                self.counts["soft_integrations"] += lp.num_soft_integrations
            self.counts["creations_dropped"] += slam.creations_dropped
        finally:
            if slam._loop is not None and slam._loop._executor is not None:
                slam._loop._executor.shutdown(wait=True)
            # a session that used its old-map view caches holds a reference
            # cycle (the caches keep bound methods of the session): free it
            # now, as a batch of recordings must, so that the next session's
            # arena does not sit beside this one until the collector runs
            alive = weakref.ref(slam)
            del slam
            if alive() is not None:
                gc.collect()
                self.counts["collections"] += 1
        return traj.astype("float64"), k

    def _start_profile(self):
        torch = self.torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.profile = torch.profiler.profile(activities=acts)
        self.profile.__enter__()
        self._traced = torch.profiler.record_function("traced")
        self._traced.__enter__()
        self._traced_t0 = time.perf_counter()

    def _stop_profile(self):
        if self.dev.type == "cuda":
            self.torch.cuda.synchronize()
        self._traced.__exit__(None, None, None)
        self._traced_s = time.perf_counter() - self._traced_t0
        self.profile.__exit__(None, None, None)


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", overrides: dict | None = None) -> dict:
    """One run of cell ``name``; returns the result object. ``overrides``
    (tests) is merged into the cell's configuration (``config``) and traffic
    (``traffic``) files; ``device`` ``"cpu"`` runs the port's plain paths."""
    spec = harness.cell(name)
    over = overrides or {}
    cfgj = harness.merge(spec["config"], over.get("config", {}))
    traffic = harness.merge(spec["traffic"], over.get("traffic", {}))
    limits = spec["limits"]
    parts = {}
    t = time.perf_counter()
    _set_caches()
    import numpy as np
    import torch
    from semantic_suma_tpu_torch.device import to_host
    from semantic_suma_tpu_torch.ops import cuda_build
    dev = torch.device(device)
    parts["imports"] = time.perf_counter() - t
    t = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.init()
        cuda_build.set_build_dir(harness.CACHE / "nvcc")
        built = cuda_build.build_all()
        if built:
            print(f"[build] {sorted(built)} built into "
                  f"{harness.CACHE / 'nvcc'}", file=sys.stderr)
    parts["context_and_kernels"] = time.perf_counter() - t
    t = time.perf_counter()
    cfg = port_config(cfgj["suma"])
    scans, gt = generator.render_sequence(traffic, cfgj["suma"]["data"],
                                          cfgj["sensor"], abs(int(seed)),
                                          dev)
    scan_bytes = sum(x.numel() * x.element_size() for s in scans for x in s)
    parts["render"] = time.perf_counter() - t
    t = time.perf_counter()
    seg = None
    segj = cfgj.get("segmenter")
    if cfgj["labels"] == "segmenter":
        from semantic_suma_tpu_torch.models.segmenter import Segmenter
        from semantic_suma_tpu_torch.config import DataConfig
        seg = Segmenter.load(str(harness.ROOT / segj["weights"]),
                             DataConfig(**segj["data"]),
                             use_knn=segj["use_knn"], device=dev)
    parts["weights"] = time.perf_counter() - t
    t = time.perf_counter()
    rep = Replay(cfg, traffic, dev, seg, trace=False)
    warm = scans[:int(traffic["warmup_scans"])]
    # the loop phases' programs, pose-graph solves and rebase once, on a
    # session of the cell's configuration, then a short session as the
    # window runs it
    from semantic_suma_tpu_torch.core.pipeline import SurfelSLAM
    if cfg.loop.enabled:
        s0 = SurfelSLAM(cfg, pipeline_depth=rep.depth, device=dev)
        s0.process_scan(warm[0].points, warm[0].labels, warm[0].probs,
                        warm[0].valid)
        s0._loop.warmup(s0)
        if s0._loop._executor is not None:
            s0._loop._executor.shutdown(wait=True)
        del s0
    rep.sequence(warm)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    parts["warmup"] = time.perf_counter() - t
    setup_s = time.perf_counter() - T_PROCESS

    # -- the window ---------------------------------------------------------
    n = len(scans)
    rng = np.random.default_rng(abs(int(seed)) + 1)
    check_idx = sorted(int(i) for i in rng.choice(
        n, size=min(n, int(traffic["check_scans"])), replace=False))
    rep = Replay(cfg, traffic, dev, seg, trace=bool(trace))
    online = traffic["mode"] == "online"
    prof_scans = traffic["trace_scans"] if trace else None
    trajectories, seq_ends = [], []
    reads0 = to_host.count
    t_start = time.perf_counter()
    t_due0 = t_start + rep.period if online else None
    k = 0
    while True:
        first = not trajectories
        traj, k = rep.sequence(
            scans, t_due0=t_due0, k0=k,
            capture=check_idx if first and seg is not None else (),
            profile_scans=prof_scans if first else None)
        trajectories.append(traj)
        seq_ends.append(time.perf_counter())
        if time.perf_counter() - t_start >= seconds:
            break
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t_end = time.perf_counter()
    window_s = t_end - (t_due0 if online else t_start)
    host_reads = to_host.count - reads0
    total = n * len(trajectories)
    failed = n * sum(not np.all(np.isfinite(tr)) for tr in trajectories)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    record = {"scans": total, "window_s": window_s, "host_reads": host_reads,
              "laps": rep.laps, "mode": traffic["mode"],
              "counts": rep.counts, "latencies": rep.latencies,
              "lateness": rep.lateness,
              "data_pixels": cfg.data.height * cfg.data.width,
              "model_cells": cfg.model.height * cfg.model.width}
    traced = {}
    if trace:
        record["stages"] = rep.timer.summary()
        if rep.seg_events:
            torch.cuda.synchronize()
            record["segmenter_ms"] = sum(a.elapsed_time(b) for a, b in
                                         rep.seg_events) / len(rep.seg_events)
        if segj is not None:
            record["flops_per_scan"] = harness.net(
                segj["arch"]).forward_flops(segj)
        if rep.profile is not None:
            path = harness.CACHE / "trace.json"
            path.parent.mkdir(parents=True, exist_ok=True)
            rep.profile.export_chrome_trace(str(path))
            with open(path) as f:
                events = json.load(f)
            events = events.get("traceEvents", events)
            traced = harness.reduce_trace(events)
            record["trace"] = traced
            record["spans"] = spans.reduce(events)
            path.unlink()

    # -- the check ----------------------------------------------------------
    ates = [yardstick.ate_rmse(gt, tr) for tr in trajectories]
    captured = rep.captured
    traced_s = getattr(rep, "_traced_s", None)
    del rep, seg
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    from suma_bench.reference import check as ref
    rcfg = ref.suma_config(cfgj["suma"])
    numbers = {}
    with ref.precision("fp32"):
        if segj is not None and cfgj["labels"] == "segmenter":
            net = ref.Network(segj, dev,
                              weights_path=str(harness.ROOT / segj["weights"]))
            labels = [net.labels(s.points) for s in scans]
            gaps, mismatch = [], 0
            for i in check_idx:
                ref_logits, res = net.logits(scans[i].points)
                prog_logits, prog_labels = captured[i]
                gaps.append(ref.logit_gap(prog_logits, ref_logits,
                                          res.vertex_valid))
                voted, _ = net.labels(scans[i].points, logits=prog_logits,
                                      res=res)
                mismatch += int((voted != prog_labels).sum())
            numbers["logit_gap"] = max(gaps)
            numbers["vote_mismatch"] = mismatch
            del net
        else:
            labels = [(s.labels, s.probs) for s in scans]
        ref_traj = ref.slam_trajectory(rcfg, scans, labels, traffic["mode"],
                                       int(traffic["pipeline_depth"]), dev)
    numbers["pose_gap_m"] = ref.pose_gap(trajectories, ref_traj)
    ref_s = time.perf_counter() - t_ref
    checks = {k: {"value": numbers[k], "limit": limits[k]}
              for k in limits}
    correct = failed == 0 and all(
        c["value"] <= c["limit"] for c in checks.values())

    # -- the result ---------------------------------------------------------
    names = ([m["name"] for m in spec["per_layer"]] if trace
             else [m["name"] for m in spec["end_to_end"]])
    units = {m["name"]: m["unit"]
             for m in spec["per_layer"] + spec["end_to_end"]}
    if trace:
        values = harness.read_metrics(names, record)
    else:
        values = {"setup_s": setup_s,
                  "device_mem_peak_gib": (peak - scan_bytes) / GIB}
        values["scans_per_s"] = total / window_s
        if online:
            values["scan_latency_p95_ms"] = float(np.percentile(
                np.asarray(record["latencies"]) * 1e3, 95))
    metrics = {k: {"value": values[k], "unit": units[k]}
               for k in names if k in values}
    result = {"correct": bool(correct), "attempted": int(total),
              "failed": int(failed), "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                         "kind": (torch.cuda.get_device_name(dev)
                                  if dev.type == "cuda" else "cpu"),
                         "count": 1, "memory_peak_bytes": int(peak)}}
    if traced:
        result["device"]["busy_s"] = traced["busy_s"]
        result["device"]["window_s"] = traced["window_s"]
        result["breakdown"] = harness.breakdown(traced)
    result["checks"] = checks
    result["_log"] = {
        "setup_parts_s": parts, "setup_s": setup_s, "sequences":
        len(trajectories), "window_s": window_s,
        "scans_per_s": total / window_s, "ate_m": [min(ates), max(ates)],
        "ate_reference_m": yardstick.ate_rmse(gt, ref_traj),
        "kitti_rel_reference": yardstick.kitti_rel_errors(gt, ref_traj),
        "counts": record["counts"], "reference_s": ref_s,
        "scan_bytes": scan_bytes, "host_reads": host_reads,
        "sequence_s": list(np.diff([t_start] + seq_ends))}
    if traced_s is not None:
        a, b = prof_scans
        result["_log"]["tracing"] = {
            "window_scans_per_s": total / window_s,
            "profiled_scans_per_s": (min(b, n) - a) / traced_s}
    if online:
        lat = np.asarray(record["latencies"]) * 1e3
        result["_log"]["lateness_ms_max"] = 1e3 * max(record["lateness"])
        result["_log"]["latency_ms"] = {
            "p50": float(np.percentile(lat, 50)),
            "p90": float(np.percentile(lat, 90)),
            "p99": float(np.percentile(lat, 99)), "max": float(lat.max()),
            "by_scan_of_sequence_mean": [
                round(float(v), 3) for v in lat.reshape(-1, n).mean(0)]}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    chips = harness.cell(args.workload)["cell"]["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"suma_bench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found", file=sys.stderr)
        return 3
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace))
    bad = harness.forbidden_modules(sys.modules)
    if bad:
        print(f"suma_bench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    log = result.pop("_log")
    log["card"] = _power_limit()
    print(f"[run] {json.dumps(log)}", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"[check] {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
