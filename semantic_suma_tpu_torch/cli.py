"""Headless command-line entry point of the port (counterpart of
``semantic_suma_tpu/cli.py``):

  python -m semantic_suma_tpu_torch.cli run --synthetic 150 --eval
  python -m semantic_suma_tpu_torch.cli run --dataset /path/to/sequences/00 \\
      --export-poses est.txt --eval --save-map map.ply
  python -m semantic_suma_tpu_torch.cli eval --gt poses/00.txt --est est.txt
  python -m semantic_suma_tpu_torch.cli --cpu run --config small.xml \\
      --synthetic 20 --eval
  python -m semantic_suma_tpu_torch.cli run --synthetic 100 \\
      --save-checkpoint s.npz --plot-dir plots --save-viewer map.html
  python -m semantic_suma_tpu_torch.cli run --synthetic 150 --resume s.npz
  python -m semantic_suma_tpu_torch.cli train-segmenter --synthetic 96 --mid \\
      --steps 2000 --batch 8 --lr 2e-3 --out w.pkl
  python -m semantic_suma_tpu_torch.cli train-segmenter --arch salsanext \\
      --synthetic 96 --steps 3000 --batch 8 --lr 2e-3 --out w.pkl
  python -m semantic_suma_tpu_torch.cli train-segmenter --arch squeezesegv3 \\
      --synthetic 96 --steps 1500 --batch 8 --lr 2e-3 --out w.pkl

Every command goes to the GPU unless the top-level ``--cpu`` is given;
without a GPU it fails rather than falling back to the CPU. The printed
lines keep the JAX package's format (``processed N scans in ...``, then the
evaluation JSON; ``train-segmenter``'s ``{"val_miou": ..., "weights":
...}``), so one parser reads both. ``--segmenter-weights`` labels every scan
with the network (``models/segmenter``) instead of the simulator's or the
files' labels. ``--save-checkpoint`` / ``--resume`` write and read the JAX
package's session archive (``utils/checkpoint``), ``--plot-dir`` its PNGs
(``utils/viz``) and ``--save-viewer`` its WebGL page (``utils/viz3d``). The
top-level ``--cache-dir`` names the directory the CUDA kernels are built
into. ``run --sharded N`` runs the sharded pipeline (``parallel/``) as N
ranks on this host: the CLI starts them itself, every rank drives the same
scans, rank 0's lines are printed and rank 0 writes the exports; the
backend follows ``parallel.distributed``'s rule and the exit code is
non-zero if any rank fails. No flag is refused.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import time
from collections import deque
from dataclasses import replace

import numpy as np
import torch

def _add_common(p):
    p.add_argument("--config", help="reference-format XML config file")
    p.add_argument("--approach", choices=["frame-to-model", "frame-to-frame"],
                   default=None)
    p.add_argument("--no-semantics", action="store_true")
    p.add_argument("--no-loop-closure", action="store_true")
    p.add_argument("--max-scans", type=int, default=None)
    p.add_argument("--surfel-capacity", type=int, default=1 << 21)
    p.add_argument("--active-capacity", type=int, default=1 << 18)
    p.add_argument("--sharded", type=int, default=None, metavar="N",
                   help="run the sharded pipeline as N ranks on this host "
                        "(the map split over the ranks; the backend is "
                        "nccl if every rank has a card of its own, else "
                        "gloo)")


def build_config(args):
    """The run's configuration: ``SumaConfig()``, then the XML file, then the
    capacities, the fresh-region sizing and the switches of ``args``."""
    from .config import SumaConfig, config_from_xml
    cfg = SumaConfig()
    if args.config:
        cfg = config_from_xml(args.config, cfg)
    # the fresh region as the JAX package's CLI sizes it (measured there on
    # the 140/150-scan ledger runs): loops on -> 1.5 images (a 2-image
    # region clips the rendered model periphery and costs loop-verification
    # accuracy), loops off -> 2 images (fewer view refreshes)
    hw = cfg.data.height * cfg.data.width
    loop_on = cfg.loop.enabled and not args.no_loop_closure
    fresh = hw + hw // 2 if loop_on else 2 * hw
    cfg = cfg.replace(map=replace(
        cfg.map,
        surfel_capacity=args.surfel_capacity,
        active_capacity=args.active_capacity,
        min_fresh_rows=min(fresh, args.active_capacity // 2),
        max_poses=max(8192, (args.max_scans or 8192))))
    if args.approach:
        cfg = cfg.replace(approach=args.approach)
    if args.no_semantics:
        cfg = cfg.replace(semantic=cfg.semantic.__class__(enabled=False))
    if args.no_loop_closure:
        cfg = cfg.replace(loop=cfg.loop.__class__(enabled=False))
    return cfg


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_map_ply(path: str, state, map_cfg, min_confidence: float = 0.0) -> None:
    """Export the world-frame surfels as a binary PLY point cloud with
    normals, radius, confidence and semantic colour."""
    from .core.surfel_map import sync
    from .models.labels import label_colors
    d = sync(state.map, map_cfg).data
    valid = _np(d.valid) & (_np(d.confidence) >= min_confidence)
    pos = _np(d.wpos)[valid]
    nrm = _np(d.wnormal)[valid]
    rgb = label_colors(_np(d.sem_label)[valid])
    rec = np.empty(pos.shape[0], dtype=[
        ("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
        ("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4"),
        ("radius", "<f4"), ("confidence", "<f4"),
        ("red", "u1"), ("green", "u1"), ("blue", "u1")])
    rec["x"], rec["y"], rec["z"] = pos.T
    rec["nx"], rec["ny"], rec["nz"] = nrm.T
    rec["radius"] = _np(d.radius)[valid]
    rec["confidence"] = _np(d.confidence)[valid]
    rec["red"], rec["green"], rec["blue"] = rgb.T
    with open(path, "wb") as f:
        hdr = ("ply\nformat binary_little_endian 1.0\n"
               f"element vertex {pos.shape[0]}\n")
        for c in ("x", "y", "z", "nx", "ny", "nz"):
            hdr += f"property float {c}\n"
        hdr += ("property float radius\nproperty float confidence\n"
                "property uchar red\nproperty uchar green\n"
                "property uchar blue\nend_header\n")
        f.write(hdr.encode())
        f.write(rec.tobytes())
    print(f"wrote {pos.shape[0]} surfels to {path}")


def save_cloud_ply(path: str, cloud: np.ndarray) -> None:
    """Plain xyz point-cloud PLY (aggregated raw scans, no surfel attrs)."""
    with open(path, "wb") as f:
        hdr = ("ply\nformat binary_little_endian 1.0\n"
               f"element vertex {cloud.shape[0]}\n"
               "property float x\nproperty float y\nproperty float z\n"
               "end_header\n")
        f.write(hdr.encode())
        f.write(np.ascontiguousarray(cloud[:, :3], "<f4").tobytes())
    print(f"wrote {cloud.shape[0]} points to {path}")


def _open_source(args, cfg, device):
    """(reader, gt poses or None, scan count, get_scan) of a run."""
    segmenter = None
    if args.segmenter_weights:
        from .models.segmenter import Segmenter
        segmenter = Segmenter.load(args.segmenter_weights, cfg.data,
                                   device=device)

    if args.synthetic:
        from .io.simulation import SimulationReader, default_world
        world = default_world(seed=0, movable_fraction=args.movable_fraction)
        reader = SimulationReader(cfg.data, n_scans=args.synthetic,
                                  world=world, radius=args.synthetic_radius,
                                  noise_sigma=args.noise,
                                  step=args.synthetic_step, device=device)
        gt = _np(reader.poses)
        count = args.synthetic

        def get_scan(i):
            s = reader.read(i)
            if segmenter is not None:
                # labels from the network, not the simulator: the
                # KITTIReader.cpp:173-200 contract on synthetic data (every
                # ray goes in, invalid ones included, as in the JAX CLI)
                labels, probs = segmenter(s.points)
                return s.points, labels, probs, s.valid
            return s.points, s.labels, s.probs, s.valid
    else:
        from .io.kitti import KITTIReader
        reader = KITTIReader(args.dataset, segmenter=segmenter,
                             use_gt_labels=not args.no_gt_labels)
        gt = reader.gt_poses()
        count = reader.count()

        def get_scan(i):
            s = reader.read(i)
            return s.points, s.labels, s.probs, None

    return reader, gt, min(count, args.max_scans or count), get_scan


def _build_kernels(device) -> None:
    if device.type == "cuda":
        # the kernels build at first use: build them here, so that the
        # compiler's time stands on its own line and not in the first scans
        from .ops import cuda_build
        t_b = time.perf_counter()
        built = cuda_build.build_all()
        print(f"kernels built in {time.perf_counter() - t_b:.1f}s "
              f"({sorted(built) or 'none stale'})", file=sys.stderr)


def cmd_run(args) -> int:
    from .device import resolve_device
    device = resolve_device("cpu" if args.cpu else None)
    if args.sharded:
        return _run_sharded(args, device)
    _drive(args, device)
    return 0


def _drive(args, device, mesh=None):
    """The drive of ``run``: on one device, or (``mesh``) as one rank of
    the sharded pipeline, where every rank drives the same scans and only
    rank 0 prints and writes the exports. Returns the session."""
    from .utils import metrics

    cfg = build_config(args)
    reader, gt, count, get_scan = _open_source(args, cfg, device)
    t_l = time.perf_counter()
    if mesh is None:
        from .core.pipeline import SurfelSLAM
        from .utils.checkpoint import load_checkpoint
        _build_kernels(device)
        slam = load_checkpoint(args.resume, cfg, device=device) \
            if args.resume else SurfelSLAM(cfg, device=device)
    else:
        from .parallel.sharding import ShardedSurfelSLAM
        from .utils.checkpoint import load_checkpoint_sharded
        slam = load_checkpoint_sharded(args.resume, cfg, mesh) \
            if args.resume else ShardedSurfelSLAM(cfg, mesh)
    start = len(slam.poses)
    if args.resume:
        print(f"resumed{' sharded' if mesh else ''} at scan {start} from "
              f"{args.resume}", file=sys.stderr)
        print(f"checkpoint loaded in {time.perf_counter() - t_l:.3f} s",
              file=sys.stderr)
    lead = mesh is None or mesh.rank == 0

    evlog = None
    if args.stats_json and lead:
        from .utils.eventlog import EventLog
        # mode "w": each run writes a self-contained JSONL file (readers
        # count its scan records as scans)
        evlog = EventLog("run", args.stats_json, mode="w")

    accum = None
    if args.save_cloud and lead:
        from .utils.scan_accumulator import ScanAccumulator
        accum = ScanAccumulator(history_size=count,
                                stride=max(1, count // 200))

    # pipelined: up to pipeline_depth scans in flight; loop closure
    # drains to synchronous operation whenever its state machine needs it
    pend_pts: deque = deque()
    pend_valid: deque = deque()

    def on_stats(stats):
        # fires per finished scan from inside the pipelined loop, in scan
        # order
        idx_d = len(slam.statistics) - 1
        if evlog is not None:
            evlog.log("scan", idx=idx_d, **stats)
        if accum is not None:
            accum.insert(pend_pts.popleft(), slam.poses[-1],
                         pend_valid.popleft())
        if args.verbose and idx_d % 10 == 0:
            print(f"scan {idx_d}/{count}: iters={stats['icp-iterations']} "
                  f"map={stats['map-count']} "
                  f"loops={stats.get('loop-closures', 0)}", file=sys.stderr)

    slam.stats_callback = on_stats
    if slam._loop is not None and getattr(slam, "supports_fused_verify",
                                          False):
        # build every loop-phase routine before the drive, not mid-lap
        t_w = time.perf_counter()
        slam._loop.warmup(slam)
        print(f"loop programs warmed in {time.perf_counter() - t_w:.1f}s",
              file=sys.stderr)
    t0 = time.perf_counter()
    t_steady = None  # the clock restarted after the first scans
    steady_at = start + 10
    for i in range(start, count):
        if i == steady_at:
            t_steady = time.perf_counter()
        pts, labels, probs, valid = get_scan(i)
        if accum is not None:
            pend_pts.append(pts)
            pend_valid.append(valid)
        slam.process_scan_async(pts, labels, probs, valid)
    # drain, then (one device) one last pose-graph solve over all edges; the
    # sharded session has no finalize, as in the JAX package
    getattr(slam, "finalize", slam.flush)()
    wall = time.perf_counter() - t0
    n_done = count - start
    est = slam.trajectory()
    msg = (f"processed {n_done} scans in {wall:.1f}s "
           f"({n_done / max(wall, 1e-9):.2f} scans/s)")
    if t_steady is not None and count - steady_at >= 20:
        # the first scans pay one-time costs (library handles, workspace
        # tables); steady state is the comparable throughput
        sps = (count - steady_at) / max(time.perf_counter() - t_steady, 1e-9)
        msg += f" [steady-state {sps:.2f} scans/s]"
    print(msg)
    sp = slam.spill
    spill = [sp.spilled_rows, len(sp.chunks), sp.chunks_paged_in, sp.probes,
             sp.futile_verdicts, sp.stale_verdicts] if sp is not None \
        else [0] * 6
    if mesh is not None:  # every rank's counters, summed
        spill = np.sum(mesh.group.objects(spill), axis=0)
    print(f"map {slam.statistics[-1]['map-count'] if slam.statistics else 0}"
          f" surfels; creations dropped {slam.creations_dropped}; spill: "
          + (f"{spill[0]} rows in {spill[1]} chunks, {spill[2]} chunks "
             f"paged in, {spill[3]} probes ({spill[4]} futile, {spill[5]} "
             "stale)" if sp is not None else "off"), file=sys.stderr)
    lc = slam._loop
    if lc is not None:
        print(f"loop closures {lc.num_loop_closures}, optimizations "
              f"{lc.num_optimizations}, rebases {lc.num_rebases}",
              file=sys.stderr)
    graphs = getattr(slam, "_graphs", None)
    if graphs is not None:
        # the step's stages: captured, replayed and eager calls, and why
        # the eager ones did not replay
        print(f"step graphs: {json.dumps(graphs.replayer.summary())}",
              file=sys.stderr)
        if evlog is not None:
            evlog.log("step-graphs", **graphs.replayer.summary())
    sw = getattr(slam, "stopwatch", None)
    if args.verbose and sw is not None:
        print(sw.report(), file=sys.stderr)
    if evlog is not None and sw is not None:
        evlog.log("stage-times", **{k: v["mean_ms"] for k, v in
                                    sw.summary().items()})

    if args.save_checkpoint:
        from .utils.checkpoint import save_checkpoint
        t_s = time.perf_counter()
        save_checkpoint(slam, args.save_checkpoint)
        print(f"checkpoint -> {args.save_checkpoint}", file=sys.stderr)
        print(f"checkpoint saved in {time.perf_counter() - t_s:.3f} s",
              file=sys.stderr)
    if not lead:
        return slam

    if args.export_poses:
        from .io.kitti import save_poses
        save_poses(args.export_poses, est, getattr(reader, "tr", None))
        print(f"poses -> {args.export_poses}")

    if evlog is not None:
        evlog.close()

    if args.save_map:
        if mesh is None:
            save_map_ply(args.save_map, slam.state, cfg.map)
        else:
            print("--save-map: sharded sessions are exported per shard via "
                  "--save-checkpoint; PLY export is single-chip only",
                  file=sys.stderr)

    if args.save_viewer:
        if mesh is None:
            from .utils.viz3d import export_map_html
            export_map_html(args.save_viewer, slam.state, cfg.map,
                            trajectory=est)
        else:
            print("--save-viewer is single-chip only", file=sys.stderr)

    if accum is not None:
        save_cloud_ply(args.save_cloud, accum.world_cloud(max_points=2_000_000))

    if args.plot_dir:
        from .utils import viz
        os.makedirs(args.plot_dir, exist_ok=True)
        loops = [i for i, s_ in enumerate(slam.statistics)
                 if s_.get("loop-verifying")]
        viz.plot_trajectory(est, np.asarray(gt) if gt is not None else None,
                            loops, os.path.join(args.plot_dir, "traj.png"))
        viz.plot_statistics(slam.statistics,
                            path=os.path.join(args.plot_dir, "stats.png"))
        viz.save_map_images(slam.model_maps,
                            prefix=os.path.join(args.plot_dir, "model"))

    if args.eval and gt is not None:
        res = metrics.evaluate(np.asarray(gt), est,
                               breakdown=args.eval_breakdown)
        if args.eval_breakdown and args.plot_dir:
            from .utils import viz
            viz.plot_error_breakdown(
                res["by_length"], res["by_speed"],
                path=os.path.join(args.plot_dir, "errors.png"))
        print(json.dumps(res, indent=2))
    return slam


# what the ranks of the last ``run --sharded`` returned (in this process):
# per rank its kernel launches, collectives, peak memory and poses
last_ranks: list = []


def _launch_counts() -> dict:
    """The kernels' launches in this process, with the calls of
    ``ops.icp.evaluate`` (one launch of kernel F each on a card) and of its
    plain linearization on CUDA tensors (none on a path)."""
    from .ops.bilateral import bilateral_filter
    from .ops.epilogue import bn_act
    from .ops.icp import (evaluate, gn_loop, gn_update, icp_products,
                          plain_on_cuda)
    from .ops.knn import knn_clean_image
    from .ops.sac import sac_modulate
    from .ops.zbuffer import zbuffer_cells
    return {"bilateral_filter": bilateral_filter.launches,
            "zbuffer_cells": zbuffer_cells.launches,
            "zbuffer_cells_by_shape": dict(zbuffer_cells.launches_by_shape),
            "knn_clean_image": knn_clean_image.launches,
            "bn_act": bn_act.launches,
            "sac_modulate": sac_modulate.launches,
            "icp_products": icp_products.launches,
            "gn_update": gn_update.launches,
            "gn_loop": gn_loop.launches,
            "evaluate_calls": evaluate.calls,
            "build_rows_on_cuda": plain_on_cuda["build_rows"]}


def _run_sharded(args, device, backend=None) -> int:
    """``run --sharded``: start the ranks, print rank 0's lines, and the
    ranks' launches, collectives and peak memory as one JSON line on
    stderr. ``backend=None`` applies ``parallel.distributed``'s rule."""
    from .ops import cuda_build
    from .parallel import distributed
    global last_ranks
    _build_kernels(device)
    n = args.sharded
    try:
        ranks = distributed.launch(
            _sharded_rank, n, (args,), cpu=device.type == "cpu",
            backend=backend, timeout_s=600.0,
            threads=max(1, (os.cpu_count() or 1) // n),
            build_dir=cuda_build.BUILD)
    except Exception as e:  # a rank failed or the ranks timed out
        print(f"ERROR: sharded run failed: {e}", file=sys.stderr)
        return 1
    last_ranks = ranks
    sys.stdout.write(ranks[0]["stdout"])
    sys.stderr.write(ranks[0]["stderr"])
    print("sharded ranks: " + json.dumps(
        [{k: jsonable(r[k]) for k in ("rank", "launches", "collectives",
                                      "peak_mib")} for r in ranks]),
        file=sys.stderr)
    return 0


def jsonable(x):
    """``x`` with tuple dictionary keys (kernel B's launches by shape) as
    ``"n,flags"`` strings."""
    if isinstance(x, dict):
        return {",".join(map(str, k)) if isinstance(k, tuple) else k:
                jsonable(v) for k, v in x.items()}
    return x


def _sharded_rank(rank: int, device, args) -> dict:
    """One rank of ``run --sharded``: :func:`_drive` on this rank's shard;
    rank 0's printed lines are returned, the other ranks' dropped."""
    from .parallel.distributed import backend
    from .parallel.sharding import make_mesh
    mesh = make_mesh(args.sharded, device=device)
    mesh.group.timing = True
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        slam = _drive(args, device, mesh)
    peak = (torch.cuda.max_memory_allocated(device) / 2**20
            if device.type == "cuda" else None)
    return {"rank": rank, "backend": backend(),
            "stdout": out.getvalue() if rank == 0 else "",
            "stderr": err.getvalue() if rank == 0 else "",
            "launches": _launch_counts(),
            "collectives": {"counts": dict(mesh.group.counts),
                            "timed": mesh.group.summary()},
            "peak_mib": peak, "poses": slam.trajectory()}


def cmd_eval(args) -> int:
    from .io.kitti import load_poses, parse_calib
    from .utils import metrics
    tr = parse_calib(args.calib).get("Tr") if args.calib else None
    gt = load_poses(args.gt, tr)
    est = load_poses(args.est, tr)
    res = metrics.evaluate(gt, est, breakdown=args.eval_breakdown)
    if args.plot_dir:
        from .utils import viz
        os.makedirs(args.plot_dir, exist_ok=True)
        viz.plot_trajectory(est, gt,
                            path=os.path.join(args.plot_dir, "traj.png"))
        if args.eval_breakdown:
            viz.plot_error_breakdown(
                res["by_length"], res["by_speed"],
                path=os.path.join(args.plot_dir, "errors.png"))
    print(json.dumps(res, indent=2))
    return 0


def _train_model(args):
    from .models import rangenet as rn
    from .models import salsanext as sn
    from .models import squeezesegv3 as sq
    if args.arch == "salsanext":
        return sn.small_salsanext() if args.small else sn.SalsaNext()
    if args.arch == "squeezesegv3":
        return sq.small_squeezesegv3() if args.small else sq.SqueezeSegV3()
    return (rn.small_rangenet() if args.small
            else rn.mid_rangenet() if args.mid else rn.RangeNet())


def cmd_train_segmenter(args) -> int:
    from .config import DataConfig
    from .device import resolve_device
    device = resolve_device("cpu" if args.cpu else None)

    def log(*a):
        print(*a, file=sys.stderr)

    cfg = DataConfig()
    if args.synthetic:
        from .models.segmenter import train_synthetic
        seg, miou = train_synthetic(
            cfg, n_train=args.synthetic, n_val=max(4, args.synthetic // 8),
            steps=args.steps, batch=args.batch, lr=args.lr, seed=args.seed,
            model=_train_model(args), log=log, device=device)
        seg.save(args.out)
        print(json.dumps({"val_miou": miou, "weights": args.out}))
        return 0 if miou > 0.5 else 1

    from .io.kitti import KITTIReader
    from .models.segmenter import train_kitti
    reader = KITTIReader(args.dataset, use_gt_labels=True)
    if reader.label_files is None:
        print("ERROR: no SemanticKITTI labels found", file=sys.stderr)
        return 1
    seg, miou = train_kitti(
        reader, cfg, epochs=args.epochs, batch=args.batch, lr=args.lr,
        seed=args.seed, model=_train_model(args),
        val_fraction=args.val_fraction, log=log, device=device)
    seg.save(args.out)
    print(json.dumps({"val_miou": miou, "weights": args.out}))
    return 0


def parse_args(argv=None) -> argparse.Namespace:
    """The parsed command line (exits with the usage on an error)."""
    ap = argparse.ArgumentParser(prog="semantic_suma_tpu_torch")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (plain PyTorch versions of the "
                         "kernels); the default is the GPU")
    ap.add_argument("--cache-dir", default=None,
                    help="build the CUDA kernels into this directory "
                         "(default: the package's build/)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    runp = sub.add_parser("run", help="run SLAM over a sequence")
    _add_common(runp)
    runp.add_argument("--dataset", help="KITTI sequence directory")
    runp.add_argument("--synthetic", type=int, default=None,
                      help="use N synthetic raycast scans instead")
    runp.add_argument("--synthetic-radius", type=float, default=18.0)
    runp.add_argument("--synthetic-step", type=float, default=1.0,
                      help="arc length per synthetic scan (m)")
    runp.add_argument("--noise", type=float, default=0.0)
    runp.add_argument("--movable-fraction", type=float, default=0.0,
                      help="fraction of synthetic boxes labeled 'car'")
    runp.add_argument("--segmenter-weights",
                      help="label scans with this segmenter (a weights "
                           "blob of either package)")
    runp.add_argument("--no-gt-labels", action="store_true")
    runp.add_argument("--export-poses")
    runp.add_argument("--stats-json",
                      help="per-scan statistics as a JSONL event log")
    runp.add_argument("--save-map")
    runp.add_argument("--save-viewer",
                      help="standalone interactive 3D map viewer HTML "
                           "(WebGL; surfels + trajectory + car glyph)")
    runp.add_argument("--save-cloud",
                      help="aggregated world-frame raw-scan cloud PLY")
    runp.add_argument("--save-checkpoint",
                      help="write a resumable session checkpoint at the end")
    runp.add_argument("--resume",
                      help="resume from a checkpoint written by "
                           "--save-checkpoint (same config/capacities)")
    runp.add_argument("--plot-dir",
                      help="write trajectory/statistics/map-image PNGs here")
    runp.add_argument("--eval", action="store_true")
    runp.add_argument("--eval-breakdown", action="store_true",
                      help="add the devkit per-segment-length and "
                           "per-speed error tables to --eval output")
    runp.add_argument("--verbose", action="store_true")
    runp.set_defaults(fn=cmd_run)

    evalp = sub.add_parser("eval", help="evaluate a pose file against GT")
    evalp.add_argument("--gt", required=True)
    evalp.add_argument("--est", required=True)
    evalp.add_argument("--calib")
    evalp.add_argument("--plot-dir",
                       help="write devkit path/error plots here")
    evalp.add_argument("--eval-breakdown", action="store_true",
                       help="add per-segment-length / per-speed tables")
    evalp.set_defaults(fn=cmd_eval)

    trainp = sub.add_parser("train-segmenter",
                            help="train the range-image segmenter")
    trainp.add_argument("--dataset",
                        help="KITTI sequence dir (omit with --synthetic)")
    trainp.add_argument("--synthetic", type=int, default=None,
                        help="train on N synthetic raycast scans instead")
    trainp.add_argument("--out", required=True)
    trainp.add_argument("--epochs", type=int, default=1)
    trainp.add_argument("--steps", type=int, default=300,
                        help="training steps (synthetic mode)")
    trainp.add_argument("--batch", type=int, default=4)
    trainp.add_argument("--lr", type=float, default=1e-3)
    trainp.add_argument("--seed", type=int, default=0)
    trainp.add_argument("--val-fraction", type=float, default=0.1,
                        help="held-out fraction for mIoU (dataset mode)")
    trainp.add_argument("--arch", choices=("rangenet_darknet", "salsanext",
                                           "squeezesegv3"),
                        default="rangenet_darknet",
                        help="the network: RangeNet++'s darknet "
                             "(models.rangenet), SalsaNext "
                             "(models.salsanext) or SqueezeSegV3 "
                             "(models.squeezesegv3)")
    trainp.add_argument("--small", action="store_true",
                        help="the test-sized variant of --arch")
    trainp.add_argument("--mid", action="store_true",
                        help="darknet21-depth deployment net (see "
                             "models.rangenet.mid_rangenet)")
    trainp.set_defaults(fn=cmd_train_segmenter)

    args = ap.parse_args(argv)
    if args.cmd == "run" and not (args.dataset or args.synthetic):
        ap.error("run requires --dataset or --synthetic")
    if args.cmd == "train-segmenter" and not (args.dataset or args.synthetic):
        ap.error("train-segmenter requires --dataset or --synthetic")
    if args.cmd == "train-segmenter" and args.mid \
            and args.arch != "rangenet_darknet":
        ap.error("--mid is a darknet network; it takes no --arch")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.cache_dir:
        from .ops import cuda_build
        cuda_build.set_build_dir(args.cache_dir)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
