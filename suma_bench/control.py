"""The control of a cell's check: the plain reference put in the program's
place, computed in the precision below the configuration's (the SLAM's
float32 products and convolutions in TF32, the network's bfloat16
convolutions in float8, emulated), and compared with the float32 reference
by the run's own numbers. A sound check reads the control as not correct.

    python3 -m suma_bench.control --workload <cell> --seeds 11 12 13

prints one line of numbers a seed. The benchmark's runs do not run it."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from suma_bench import generator, harness  # noqa: E402


def control_numbers(name: str, seed: int, device: str = "cuda",
                    overrides: dict | None = None) -> dict:
    """The cell's numbers with the control in the program's place, on the
    sequence of ``seed``."""
    import numpy as np
    import torch
    from suma_bench.reference import check as ref
    spec = harness.cell(name)
    over = overrides or {}
    cfgj = harness.merge(spec["config"], over.get("config", {}))
    traffic = harness.merge(spec["traffic"], over.get("traffic", {}))
    dev = torch.device(device)
    scans, _ = generator.render_sequence(traffic, cfgj["suma"]["data"],
                                         cfgj["sensor"], abs(int(seed)), dev)
    n = len(scans)
    rng = np.random.default_rng(abs(int(seed)) + 1)
    check_idx = sorted(int(i) for i in rng.choice(
        n, size=min(n, int(traffic["check_scans"])), replace=False))
    rcfg = ref.suma_config(cfgj["suma"])
    segj = cfgj.get("segmenter") if cfgj["labels"] == "segmenter" else None
    runs = {}
    for mode, slam_prec, net_prec in (("reference", "fp32", "fp32"),
                                      ("control", "tf32", "fp8")):
        with ref.precision(slam_prec):
            logits = {}
            if segj is not None:
                net = ref.Network(segj, dev, mode=net_prec,
                                  weights_path=str(harness.ROOT
                                                   / segj["weights"]))
                labels = [net.labels(s.points) for s in scans]
                for i in check_idx:
                    logits[i] = net.logits(scans[i].points)
                del net
            else:
                labels = [(s.labels, s.probs) for s in scans]
            traj = ref.slam_trajectory(rcfg, scans, labels, traffic["mode"],
                                       int(traffic["pipeline_depth"]), dev)
        runs[mode] = (traj, logits)
    out = {"pose_gap_m": ref.pose_gap([runs["control"][0]],
                                      runs["reference"][0])}
    if segj is not None:
        out["logit_gap"] = max(
            ref.logit_gap(runs["control"][1][i][0],
                          runs["reference"][1][i][0],
                          runs["reference"][1][i][1].vertex_valid)
            for i in check_idx)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for seed in args.seeds:
        print(json.dumps({"workload": args.workload, "seed": seed,
                          **control_numbers(args.workload, seed,
                                            args.device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
