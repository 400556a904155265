"""Accuracy ledger of the port: the odometry, noisy, loop, segmenter,
segmenter-full and sharded-8dev rows of ``scripts/make_results.py``, the
first five run through the port's CLI in this process.

    python3 -m semantic_suma_tpu_torch.tools.make_results [--quick] [--cpu]

Each row is one ``cli.main(["run", ...])`` with the arguments of the JAX
package's ledger (150 scans, the noisy row with 2 cm range noise, the
140-scan loop row with the gates of ``configs/synthetic_loop.xml`` at 1 m
steps, the segmenter rows with 30% of the boxes cars, labelled by the
versioned networks ``weights/segmenter_synth_{mid,full}.pkl``, whose
held-out mIoU the row reads from the weights' ``.json``; the networks are
looked up in ``weights/`` of the working directory, the repository's root,
or in ``--weights DIR``). The sharded-8dev row is the JAX tool's recipe: 8
ranks of ``parallel.sharding.ShardedSurfelSLAM`` (started by
``parallel.distributed.launch``) over 90 scans at 1.5 m steps, 32x450, a
2^18-row arena, a 2^16-row view, 256 poses, loops off. ``--quick`` takes 60,
80 and 30 scans, the loop row at 1.6 m steps, as the JAX tool does (which
trains a small network for its quick segmenter row instead). It prints the
RESULTS-format table and one JSON object with every row's numbers; it
writes no file of the repo. Without ``--cpu`` the runs go to the GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import sys
import tempfile
import time
from pathlib import Path

LOOP_XML = Path(__file__).resolve().parent.parent / "configs" \
    / "synthetic_loop.xml"
# segmenter row -> its versioned network, under weights/ of the working
# directory (set_weights_dir names another)
SEGMENTER_WEIGHTS = {}


def set_weights_dir(path) -> None:
    SEGMENTER_WEIGHTS.update(
        {"segmenter": Path(path) / "segmenter_synth_mid.pkl",
         "segmenter-full": Path(path) / "segmenter_synth_full.pkl"})


set_weights_dir("weights")
SHARDED_ROW = "sharded-8dev"
ROWS = ("odometry", "noisy", "loop", *SEGMENTER_WEIGHTS, SHARDED_ROW)

_PROCESSED = re.compile(
    r"processed (\d+) scans in ([\d.]+)s \(([\d.]+) scans/s\)"
    r"(?: \[steady-state ([\d.]+) scans/s\])?")
_SUMMARY = re.compile(
    r"creations dropped (\d+); spill: (?:(\d+) rows in (\d+) chunks, (\d+) "
    r"chunks paged in, (\d+) probes \((\d+) futile, (\d+) stale\)|off)")


def row_args(name: str, quick: bool = False, stats_json: str | None = None):
    """The ``run`` arguments of one ledger row (``scripts/make_results.py``:
    odometry with the devkit breakdown, noisy, loop with its stats file)."""
    n_odo = 60 if quick else 150
    n_loop = 80 if quick else 140
    if name == "odometry":
        return ["run", "--synthetic", str(n_odo), "--no-loop-closure",
                "--eval", "--eval-breakdown"]
    if name == "noisy":
        return ["run", "--synthetic", str(n_odo), "--noise", "0.02",
                "--no-loop-closure", "--eval"]
    if name == "loop":
        out = ["run", "--synthetic", str(n_loop), "--config", str(LOOP_XML),
               "--synthetic-step", "1.6" if quick else "1.0", "--eval"]
        return out + (["--stats-json", stats_json] if stats_json else [])
    if name in SEGMENTER_WEIGHTS:
        return ["run", "--synthetic", str(n_odo), "--movable-fraction", "0.3",
                "--segmenter-weights", str(SEGMENTER_WEIGHTS[name]),
                "--no-loop-closure", "--eval"]
    raise ValueError(f"unknown row {name!r}")


def val_miou(name: str):
    """The held-out mIoU recorded beside a segmenter row's weights, or
    None."""
    meta = Path(str(SEGMENTER_WEIGHTS[name]) + ".json")
    return json.loads(meta.read_text()).get("val_miou") \
        if meta.exists() else None


def last_json(text: str) -> dict:
    """The last JSON object printed (the CLI's evaluation)."""
    dec = json.JSONDecoder()
    objs, i = [], 0
    while (j := text.find("{", i)) >= 0:
        try:
            obj, end = dec.raw_decode(text[j:])
            objs.append(obj)
            i = j + end
        except ValueError:
            i = j + 1
    if not objs:
        raise RuntimeError(f"no JSON in the CLI's output:\n{text}")
    return objs[-1]


def parse_run(stdout: str, stderr: str) -> dict:
    """The numbers of one ``run`` of either package's CLI: the evaluation,
    the scan rates, and (the port's) creations dropped and spill
    counters."""
    out = dict(last_json(stdout))
    m = _PROCESSED.search(stdout)
    if m is None:
        raise RuntimeError(f"no 'processed' line in:\n{stdout}")
    out["scans"] = int(m.group(1))
    out["wall_s"] = float(m.group(2))
    out["scans_per_sec"] = float(m.group(3))
    out["steady_scans_per_sec"] = (float(m.group(4)) if m.group(4)
                                   else None)
    # the port's map summary (the JAX CLI prints none)
    s = _SUMMARY.search(stderr)
    out["creations_dropped"] = int(s.group(1)) if s else None
    spill = [int(g) for g in s.groups()[1:] if g is not None] if s else []
    out["spill"] = dict(zip(("rows", "chunks", "paged_in", "probes",
                             "futile", "stale"), spill)) if spill else None
    return out


def _sharded_rank(rank: int, device, n: int) -> dict:
    """One rank of the sharded-8dev row (``scripts/make_results.py``);
    rank 0's numbers carry its evaluation and per-scan statistics."""
    from dataclasses import replace

    import numpy as np
    import torch

    from ..config import DataConfig, SumaConfig
    from ..io.simulation import SimulationReader
    from ..parallel import sharding as sh
    from ..utils import metrics

    d = DataConfig(width=450, height=32)
    cfg = SumaConfig(data=d, model=d)
    cfg = cfg.replace(map=replace(cfg.map, surfel_capacity=1 << 18,
                                  active_capacity=1 << 16, max_poses=256))
    reader = SimulationReader(cfg.data, n_scans=n, radius=18.0, step=1.5,
                              device=device)
    mesh = sh.make_mesh(8, device=device)
    mesh.group.timing = True
    slam = sh.ShardedSurfelSLAM(cfg, mesh, enable_loop_closure=False)
    t0 = time.perf_counter()
    for i in range(n):
        s = reader.read(i)
        slam.process_scan(s.points, s.labels, s.probs, s.valid)
    wall = time.perf_counter() - t0
    from ..cli import _launch_counts
    out = {"rank": rank, "scans": n, "wall_s": wall,
           "scans_per_sec": n / max(wall, 1e-9),
           "creations_dropped": slam.creations_dropped,
           "map_count": slam.statistics[-1]["map-count"],
           "launches": _launch_counts(),
           "collectives": {"counts": dict(mesh.group.counts),
                           "timed": mesh.group.summary()},
           "peak_mib": (torch.cuda.max_memory_allocated(device) / 2**20
                        if device.type == "cuda" else None)}
    if rank == 0:
        out.update(metrics.evaluate(np.asarray(reader.poses.cpu()),
                                    slam.trajectory()))
        out["statistics"] = slam.statistics
    return out


def run_sharded_row(cpu: bool = False, quick: bool = False) -> dict:
    """The sharded-8dev row: 8 ranks on this host; rank 0's numbers, with
    every rank's launches, collectives and peak memory under ``ranks``."""
    import os

    from ..device import resolve_device
    from ..ops import cuda_build
    from ..parallel.distributed import launch
    n = 30 if quick else 90
    device = resolve_device("cpu" if cpu else None)
    if device.type == "cuda":
        cuda_build.build_all()
    t0 = time.perf_counter()
    ranks = launch(_sharded_rank, 8, (n,), cpu=cpu, timeout_s=600.0,
                   threads=max(1, (os.cpu_count() or 1) // 8),
                   build_dir=cuda_build.BUILD)
    row = {k: v for k, v in ranks[0].items() if k not in
           ("launches", "collectives", "peak_mib", "rank", "statistics")}
    row.update(call_s=time.perf_counter() - t0, steady_scans_per_sec=None,
               argv=["sharded-8dev", str(n)], stderr="",
               ranks=[{k: r[k] for k in ("rank", "launches", "collectives",
                                         "peak_mib", "scans_per_sec")}
                      for r in ranks])
    return row


def run_row(name: str, cpu: bool = False, quick: bool = False) -> dict:
    """One ledger row through ``cli.main`` in this process (the sharded row
    through its 8 ranks)."""
    if name == SHARDED_ROW:
        return run_sharded_row(cpu, quick)
    from ..cli import main
    with tempfile.TemporaryDirectory() as td:
        stats = os.path.join(td, "stats.jsonl") if name == "loop" else None
        argv = (["--cpu"] if cpu else []) + row_args(name, quick, stats)
        out, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = main(argv)
        if rc != 0:
            raise RuntimeError(f"cli {' '.join(argv)} returned {rc}")
        row = parse_run(out.getvalue(), err.getvalue())
        row["call_s"] = time.perf_counter() - t0
        row["argv"] = argv
        row["stderr"] = err.getvalue()
        if name in SEGMENTER_WEIGHTS:
            row["val_miou"] = val_miou(name)
        if stats:
            with open(stats) as f:
                scans = [json.loads(line) for line in f if line.strip()]
            row["loop_closures"] = max(
                (e.get("loop-closures", 0) for e in scans
                 if e.get("event") == "scan"), default=0)
    return row


def table(rows: dict) -> str:
    """The RESULTS.md table of ``rows`` (``scripts/make_results.py``)."""
    def fmt(v):
        return f"{v:.4f}" if isinstance(v, float) else str(v)

    lines = ["| run | scans | ATE RMSE (m) | t_rel (%) | r_rel (deg/100m) |"
             " final err (m) | extra |", "|---|---|---|---|---|---|---|"]
    for name, r in rows.items():
        sps = r.get("steady_scans_per_sec") or r.get("scans_per_sec")
        extra = f"{sps:.1f} scans/s" if name != "noisy" and sps else ""
        if r.get("val_miou") is not None:
            extra = ", ".join([f"mIoU={r['val_miou']:.3f}"]
                              + ([extra] if extra else []))
        if name == "loop":
            extra = ", ".join([f"loops={r.get('loop_closures', 0)}"]
                              + ([extra] if extra else []))
        nan = float("nan")
        lines.append(
            f"| {name} | {r['scans']} | {fmt(r.get('ate_rmse_m', nan))} "
            f"| {fmt(r.get('t_rel_percent', nan))} "
            f"| {fmt(r.get('r_rel_deg_per_100m', nan))} "
            f"| {fmt(r.get('final_error_m', nan))} | {extra} |")
    odo = rows.get("odometry", {})
    if odo.get("by_length"):
        lines += ["", "Devkit breakdown (odometry run):", "",
                  "| segment | t_rel (%) | r_rel (deg/100m) | n |",
                  "|---|---|---|---|"]
        for part in ("by_length", "by_speed"):
            for key, e in odo.get(part, {}).items():
                lines.append(f"| {key} | {e['t_rel_percent']:.4f} "
                             f"| {e['r_rel_deg_per_100m']:.4f} "
                             f"| {e['count']} |")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="60 / 80 scans instead of 150 / 140")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the default is the GPU)")
    ap.add_argument("--weights", default="weights",
                    help="directory of the versioned segmenter networks")
    args = ap.parse_args(argv)
    set_weights_dir(args.weights)
    rows = {}
    for name in ROWS:
        rows[name] = run_row(name, cpu=args.cpu, quick=args.quick)
        print(f"[{name}] {' '.join(rows[name]['argv'])}: "
              f"{rows[name]['call_s']:.1f} s", file=sys.stderr)
    print(table(rows))
    from ..cli import jsonable
    print(json.dumps({k: jsonable({f: v for f, v in r.items()
                                   if f != "stderr"})
                      for k, r in rows.items()}, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
