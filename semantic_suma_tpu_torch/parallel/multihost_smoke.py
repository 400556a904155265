"""Multi-process smoke (counterpart of
``semantic_suma_tpu/parallel/multihost_smoke.py``): the sharded odometry over
a group spanning every process, with an arena small enough that host spill
pages chunks out and back in, then one data-parallel segmenter training
step. Prints one ``MULTIHOST OK`` line per process on success.

Run one command per process (each host, or one host):

    python -m semantic_suma_tpu_torch.parallel.multihost_smoke \\
        --coordinator host0:12355 --num-processes 2 --process-id {0,1}

``--cpu`` runs the ranks on the CPU (gloo); otherwise each rank computes on
its card (``parallel.distributed``'s backend rule). The page-ins of one
process never move ``map_version`` on the others (JAX's multi-process
rule).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default="localhost:12355")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--cpu", action="store_true",
                    help="run the ranks on the CPU (gloo)")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds a collective may wait before it raises")
    ap.add_argument("--threads", type=int, default=None,
                    help="intra-op threads of this process")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if args.threads:
        torch.set_num_threads(args.threads)

    from . import distributed
    device = distributed.initialize(args.coordinator, args.num_processes,
                                    args.process_id, timeout_s=args.timeout,
                                    cpu=args.cpu)
    try:
        return _run(args, device, np, torch)
    finally:
        # the session holds the process group in reference cycles: free it
        # first, so that the group's threads end here and not in the
        # interpreter's teardown
        import gc
        gc.collect()
        torch.distributed.destroy_process_group()


def _run(args, device, np, torch) -> int:
    from ..config import DataConfig, IcpConfig, MapConfig, SumaConfig
    from ..io.simulation import circular_trajectory, default_world, \
        render_scan
    from ..models import rangenet as rn
    from ..models.segmenter import create_train_state
    from . import sharding as sh

    pid = args.process_id
    mesh = sh.make_mesh(device=device)
    ndev = mesh.size
    print(f"proc {pid}: 1 local / {ndev} global devices ({device})",
          flush=True)

    # ---- sharded odometry over the whole group ---------------------------
    # a tiny arena and active radius: the circle fills each rank's arena in
    # a few scans (spill out) and the second lap revisits the start (page
    # in); the arena (6144 rows a rank) exceeds the view (4096 rows a rank)
    height = 32 if 32 % ndev == 0 else ndev * 4
    d = DataConfig(width=128, height=height)
    cfg = SumaConfig(data=d, model=d, icp=IcpConfig(max_iterations=3),
                     map=MapConfig(surfel_capacity=ndev * 6144,
                                   active_capacity=ndev * 4096, max_poses=64,
                                   submap_dimension=1, submap_extent=2.0,
                                   spill_margin=2.0, unspill_margin=12.0,
                                   spill_chunk_blocks=1))
    slam = sh.ShardedSurfelSLAM(cfg, mesh, single_process=False)
    world = default_world(seed=0)
    n_scans = 24
    gt = circular_trajectory(n_scans, radius=4.0, step=2.1)
    max_spilled = 0
    for t in range(n_scans):
        scan = render_scan(world, gt[t].to(device), cfg.data)
        info = slam.process_scan(scan.points, scan.labels, scan.probs,
                                 scan.valid)
        max_spilled = max(max_spilled, slam.spilled_rows)
    assert info["map-count"] > 0, "sharded fusion created no surfels"
    assert max_spilled > 0, "spill path was never crossed"
    paged_back = slam.spill.chunks_paged_in
    assert paged_back > 0, "no spilled chunk was ever paged back in"

    # ---- one data-parallel segmenter step over the group -----------------
    mesh2 = sh.make_mesh(axis="data", device=device)
    schedule, tstate = create_train_state(rn.small_rangenet(), seed=0,
                                          device=device)
    tstate = sh.shard_train_state(tstate, mesh2)
    train = sh.make_sharded_train_step(schedule, mesh2)
    tstate, metrics = train(
        tstate, torch.zeros((1, 16, 64, 5), device=device),
        torch.zeros((1, 16, 64), dtype=torch.int32, device=device),
        torch.ones((1, 16, 64), dtype=torch.bool, device=device))
    loss = float(metrics["loss"])
    assert np.isfinite(loss)

    print(f"MULTIHOST OK proc={pid} devices={ndev} "
          f"surfels={info['map-count']} max_spilled={max_spilled} "
          f"paged_back={paged_back} loss={loss:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
