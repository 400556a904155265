"""The filtered main cell in either package: ``bench.py:33-36``'s sizing (a
2^21-row arena, a 2^18-row view, a two-image fresh region, 8192 poses) with
``use_filtered_vertexmap=True``, loop closure and spill off, over the 68
noise-free scans of ``circular_trajectory(68, radius=18, step=1.5)`` in
``default_world(seed=0, extent=45)``, driven by each package's
``SurfelSLAM.process_scan`` (the map's confidence threshold follows its
warm-up schedule) or, with ``--entry bench``, by ``odometry_step`` with the
constant threshold -2.0 of ``bench.py:44-56``.

    JAX_PLATFORMS=cpu python compare/filtered_main.py jax [--save-scans s.npz]
    python compare/filtered_main.py port --device cpu [--scans s.npz]
    python compare/filtered_main.py port --device cuda

Prints one JSON line: the aligned ATE against ground truth, the Gauss-Newton
iterations of every scan, their mean over the 60 timed scans (8 on), the
scans at the iteration cap, and the seconds the run took. ``jax`` renders the
scans with the JAX simulator (``--save-scans`` writes them); ``port`` renders
them with its own simulator (the same points to ~1e-5 m), or reads the file
that ``jax --save-scans`` wrote, so that both packages align the same scans.

On the CPU the JAX package filters with the XLA ``ops/filters.
bilateral_filter``; on a TPU it runs the Pallas kernel
(``core/preprocessing.py:44-57``). The port holds its plain filter to the
Pallas kernel's arithmetic, so the two packages' filtered maps differ in
their last bits, and the 33-iteration limit cycles of this cell turn that
into different trajectories.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

N_SCANS = 68
N_WARM = 8
BENCH_CONFIDENCE = -2.0   # bench.py's constant confidence threshold
FIELDS = ("points", "labels", "probs", "valid")


def _summary(gt: np.ndarray, est: np.ndarray, iterations, cap: int,
             ate_rmse) -> dict:
    its = [int(i) for i in iterations]
    return {"scans": len(its),
            "ate_m": float(ate_rmse(gt.astype(np.float64), est)),
            "iterations_per_scan_timed": float(np.mean(its[N_WARM:])),
            "capped": [i for i, k in enumerate(its) if k >= cap],
            "iterations": its}


def run_jax(n: int, save_scans: str | None, entry: str) -> dict:
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from semantic_suma_tpu.config import (LoopClosureConfig, MapConfig,
                                          PreprocessConfig, SumaConfig)
    from semantic_suma_tpu.core.pipeline import (SurfelSLAM, init_state,
                                                 odometry_step)
    from semantic_suma_tpu.io.simulation import (circular_trajectory,
                                                 default_world, render_scan)
    from semantic_suma_tpu.utils.metrics import ate_rmse

    cfg = SumaConfig(map=MapConfig(surfel_capacity=1 << 21,
                                   active_capacity=1 << 18,
                                   min_fresh_rows=2 * 64 * 900,
                                   max_poses=8192, spill_enabled=False),
                     loop=LoopClosureConfig(enabled=False),
                     preprocess=PreprocessConfig(use_filtered_vertexmap=True))
    world = default_world(seed=0, extent=45.0)
    gt = circular_trajectory(n, radius=18.0, step=1.5)
    gen = jax.jit(lambda pose: render_scan(world, pose, cfg.data))
    scans = [jax.tree.map(np.asarray, gen(gt[i])) for i in range(n)]
    if save_scans:
        np.savez_compressed(save_scans, gt=np.asarray(gt), **{
            f"{f}_{i}": getattr(s, f) for i, s in enumerate(scans)
            for f in FIELDS})
    t0 = time.perf_counter()
    if entry == "bench":
        step = jax.jit(odometry_step, static_argnames=("cfg",))
        state, its, poses = init_state(cfg), [], []
        ct = jnp.asarray(BENCH_CONFIDENCE, jnp.float32)
        for s in scans:
            state, info = step(state, s.points, s.labels, s.probs, s.valid,
                               ct, cfg)
            its.append(int(info.iterations))
            poses.append(np.asarray(info.pose))
        est = np.stack(poses)
    else:
        slam = SurfelSLAM(cfg, enable_loop_closure=False)
        for s in scans:
            slam.process_scan(s.points, s.labels, s.probs, s.valid)
        est = slam.trajectory()
        its = [st["icp-iterations"] for st in slam.statistics]
    out = _summary(np.asarray(gt), est, its, cfg.icp.max_iterations,
                   ate_rmse)
    out["seconds"] = time.perf_counter() - t0
    out["scans_from"] = "the JAX simulator"
    return out


def run_port(n: int, device: str, scans_file: str | None,
             entry: str) -> dict:
    import torch

    from semantic_suma_tpu_torch.config import odometry_config
    from semantic_suma_tpu_torch.core.pipeline import (SurfelSLAM,
                                                       init_state,
                                                       odometry_step)
    from semantic_suma_tpu_torch.device import resolve_device
    from semantic_suma_tpu_torch.io.simulation import (circular_trajectory,
                                                       default_world,
                                                       render_scan)
    from semantic_suma_tpu_torch.utils.metrics import ate_rmse

    dev = resolve_device(device)
    cfg = odometry_config()
    if scans_file:
        z = np.load(scans_file)
        gt = z["gt"][:n]
        scans = [tuple(torch.from_numpy(z[f"{f}_{i}"]).to(dev)
                       for f in FIELDS) for i in range(n)]
        source = f"{os.path.basename(scans_file)} (the JAX simulator)"
    else:
        world = default_world(seed=0, extent=45.0)
        gt_t = circular_trajectory(n, radius=18.0, step=1.5, device=dev)
        scans = [tuple(getattr(render_scan(world, gt_t[i], cfg.data), f)
                       for f in FIELDS) for i in range(n)]
        gt = gt_t.cpu().numpy()
        source = "the port's simulator"
    t0 = time.perf_counter()
    if entry == "bench":
        state, its, poses = init_state(cfg, dev), [], []
        for s in scans:
            state, info = odometry_step(state, *s, BENCH_CONFIDENCE, cfg)
            its.append(int(info.iterations))
            poses.append(info.pose.cpu().numpy())
        est = np.stack(poses)
    else:
        slam = SurfelSLAM(cfg, device=dev)
        for s in scans:
            slam.process_scan(*s)
        est = slam.trajectory()
        its = [st["icp-iterations"] for st in slam.statistics]
    out = _summary(gt, est, its, cfg.icp.max_iterations, ate_rmse)
    out["seconds"] = time.perf_counter() - t0
    out["scans_from"] = source
    if dev.type == "cuda":
        out["device_name"] = torch.cuda.get_device_name(dev)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("package", choices=["jax", "port"])
    ap.add_argument("--device", default="cpu",
                    help="the port's device (cpu or cuda)")
    ap.add_argument("--scans-count", type=int, default=N_SCANS)
    ap.add_argument("--save-scans", help="jax: write the rendered scans here")
    ap.add_argument("--scans", help="port: read the scans from this file")
    ap.add_argument("--entry", choices=["surfelslam", "bench"],
                    default="surfelslam")
    args = ap.parse_args(argv)
    if args.package == "jax":
        out = run_jax(args.scans_count, args.save_scans, args.entry)
    else:
        out = run_port(args.scans_count, args.device, args.scans,
                       args.entry)
    print(json.dumps({"package": args.package,
                      "device": "cpu" if args.package == "jax"
                      else args.device, "entry": args.entry, **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
