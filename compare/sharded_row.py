"""The sharded-8dev row of the accuracy ledger (``scripts/make_results.py``:
8 devices, 32x450, a 2^18-row arena, a 2^16-row view, 256 poses, 90 scans at
1.5 m steps around the 18 m circle, loops off, ``process_scan``) in either
package, with the creations that the full arena dropped, which the ledger
does not print.

    JAX_PLATFORMS=cpu python compare/sharded_row.py jax
    python compare/sharded_row.py port --device cpu
    python compare/sharded_row.py port --device cuda

The JAX package runs on a virtual 8-device CPU mesh, the port on 8 ranks
(``parallel.distributed.launch``; gloo). Prints one JSON line: the
evaluation (ATE, t_rel, ...), the final map count, the dropped creations
and the first scan that dropped one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

N_SCANS = 90


def _summary(stats) -> dict:
    drops = [s["creations-dropped"] for s in stats]
    return {"map_count": stats[-1]["map-count"],
            "creations_dropped": int(sum(drops)),
            "first_drop_scan": next((i for i, d in enumerate(drops) if d),
                                    None)}


def run_jax(n: int) -> dict:
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    import jax
    jax.config.update("jax_platforms", "cpu")
    from dataclasses import replace

    import numpy as np

    from semantic_suma_tpu.config import DataConfig, SumaConfig
    from semantic_suma_tpu.io.simulation import SimulationReader
    from semantic_suma_tpu.parallel import sharding as sh
    from semantic_suma_tpu.utils import metrics

    d = DataConfig(width=450, height=32)
    cfg = SumaConfig(data=d, model=d)
    cfg = cfg.replace(map=replace(cfg.map, surfel_capacity=1 << 18,
                                  active_capacity=1 << 16, max_poses=256))
    reader = SimulationReader(cfg.data, n_scans=n, radius=18.0, step=1.5)
    slam = sh.ShardedSurfelSLAM(cfg, sh.make_mesh(8),
                                enable_loop_closure=False)
    for i in range(n):
        s = reader.read(i)
        slam.process_scan(s.points, s.labels, s.probs, s.valid)
    out = metrics.evaluate(np.asarray(reader.poses), slam.trajectory())
    out.update(_summary(slam.statistics))
    return out


def run_port(n: int, device: str) -> dict:
    from semantic_suma_tpu_torch.parallel.distributed import launch
    from semantic_suma_tpu_torch.tools.make_results import _sharded_rank
    ranks = launch(_sharded_rank, 8, (n,), cpu=device == "cpu",
                   threads=max(1, (os.cpu_count() or 1) // 8),
                   timeout_s=600.0)
    out = {k: v for k, v in ranks[0].items()
           if k not in ("launches", "collectives", "statistics")}
    out.update(_summary(ranks[0]["statistics"]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("package", choices=["jax", "port"])
    ap.add_argument("--device", default="cpu",
                    help="the port's device (cpu or cuda)")
    ap.add_argument("--scans", type=int, default=N_SCANS)
    args = ap.parse_args(argv)
    out = run_jax(args.scans) if args.package == "jax" \
        else run_port(args.scans, args.device)
    print(json.dumps({"package": args.package, **out}, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
