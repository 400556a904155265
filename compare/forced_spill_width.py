"""Position error along the forced-spill circle of ``tests/test_spill.py``
at a chosen image size, for either package: the JAX package (CPU) or the
PyTorch port (CPU or GPU). It shows how the drift of that configuration
(12 m sensor, 0.03 m range noise, seed 2, 80 scans of the 16 m circle at
1.6 m steps, loop closure with the test's gates) grows with the image
width, with host spill on or off.

    JAX_PLATFORMS=cpu python compare/forced_spill_width.py jax 32 480
    python compare/forced_spill_width.py port 32 480 --device cpu
    python compare/forced_spill_width.py port 64 900 --device cuda

The scans go through ``process_scan``, one at a time. Prints one line: the
error of the position relative to the first pose after scans 20, 40, 60
and 80 (the last after ``finalize()``), the closures and rebases, the
creations made and dropped (by scan), and with ``--spill`` the scan by
which the first chunk went to the host, the chunks paged in, the
futile-retry threshold at the end, and the port's probe counts. Image
widths must be divisible by 4 (the pyramid of the loop search).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _view_rows(hw: int) -> int:
    """The active view: the test's 2^13 rows at its 24x120, 2^16 up to
    20,000 pixels, 2^18 above."""
    return 1 << 13 if hw <= 2880 else 1 << 16 if hw <= 20000 else 1 << 18


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("package", choices=["jax", "port"])
    ap.add_argument("height", type=int)
    ap.add_argument("width", type=int)
    ap.add_argument("--arena", type=int, default=1 << 20,
                    help="surfel_capacity (rows)")
    ap.add_argument("--spill", action="store_true")
    ap.add_argument("--no-loops", action="store_true")
    ap.add_argument("--seed", type=int, default=2)
    ap.add_argument("--sigma", type=float, default=0.03)
    ap.add_argument("--device", default="cpu",
                    help="the port's device (cpu or cuda)")
    args = ap.parse_args(argv)
    from semantic_suma_tpu_torch.config import forced_spill_sections
    from semantic_suma_tpu_torch.io.simulation import rich_world
    h, w = args.height, args.width
    sec = forced_spill_sections(h, w, args.arena, _view_rows(h * w),
                                spill=args.spill, loops=not args.no_loops)
    world = rich_world()
    if args.package == "jax":
        from semantic_suma_tpu import config as c
        from semantic_suma_tpu.core.pipeline import SurfelSLAM
        from semantic_suma_tpu.io.simulation import (Box, SimulationReader,
                                                     World)
        world = World(boxes=tuple(Box(b.center, b.size, b.label)
                                  for b in world.boxes))
        kw = {}
    else:
        from semantic_suma_tpu_torch import config as c
        from semantic_suma_tpu_torch.core.pipeline import SurfelSLAM
        from semantic_suma_tpu_torch.io.simulation import SimulationReader
        kw = {"device": args.device}
    d = c.DataConfig(**sec["data"])
    cfg = c.SumaConfig(data=d, model=d, icp=c.IcpConfig(**sec["icp"]),
                       map=c.MapConfig(**sec["map"]),
                       loop=c.LoopClosureConfig(**sec["loop"]))
    n = 80
    reader = SimulationReader(cfg.data, n_scans=n, world=world, radius=16.0,
                              step=1.6, noise_sigma=args.sigma,
                              seed=args.seed, **kw)
    slam = SurfelSLAM(cfg, **kw)
    t0 = time.perf_counter()
    first_spill = None
    for i in range(n):
        s = reader.read(i)
        slam.process_scan(s.points, s.labels, s.probs, s.valid)
        if first_spill is None and slam.spill is not None \
                and slam.spill.chunks:
            first_spill = i
    slam.finalize()
    est = slam.trajectory()
    gt = np.asarray(reader.poses.cpu() if hasattr(reader.poses, "cpu")
                    else reader.poses, np.float64)
    errs = [float(np.linalg.norm(
        est[k][:3, 3] - (np.linalg.inv(gt[0]) @ gt[k])[:3, 3]))
        for k in (19, 39, 59, 79)]
    lc = slam._loop
    created = sum(st["surfels-created"] for st in slam.statistics)
    dropping = {i: st["creations-dropped"]
                for i, st in enumerate(slam.statistics)
                if st["creations-dropped"]}
    sp = slam.spill
    spill = "" if sp is None else (
        f"; spill: first chunk by scan {first_spill}, {sp.chunks_paged_in} "
        f"chunks paged in, futile-retry threshold "
        f"{slam._spill_retry_blocks} of "
        f"{cfg.map.surfel_capacity // cfg.map.effective_block_size} blocks"
        + (f", {sp.probes} probes ({sp.futile_verdicts} futile, "
           f"{sp.stale_verdicts} stale)" if hasattr(sp, "probes") else ""))
    print(f"{args.package} {h}x{w} spill={args.spill} "
          f"loops={not args.no_loops} seed={args.seed} sigma={args.sigma}: "
          f"error after scans 20/40/60/80 "
          f"{' '.join(f'{e:.3f}' for e in errs)} m; closures "
          f"{lc.num_loop_closures if lc else 0}, rebases "
          f"{lc.num_rebases if lc else 0}; map "
          f"{slam.statistics[-1]['map-count']} surfels; created {created}, "
          f"dropped {slam.creations_dropped} (by scan {dropping}){spill}; "
          f"{time.perf_counter() - t0:.0f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
