"""Kernel F's designs side by side, and where its iteration's time goes.

    python3 -m semantic_suma_tpu_torch.tools.gn_loop_designs [--turns 2]

On a card only (it exits 1 without one). Builds ``gn_loop_designs.cu``
(kernel F of ``csrc/icp.cu`` with switches, from the same device code) next
to the kernels, then at the inputs of a scan of the filtered main cell and
of the default one (``cell_inputs``, as ``chip_smoke.py`` ``[icp]`` takes
them) holds each design to ``icp.gn_loop`` bit for bit at max_iterations 1,
2 and 33, and times, in turns, one call in a replayed CUDA graph:

* ``F`` (mode 0): kernel F as built;
* ``first build`` (mode 3): slot-major partial sums and one load in flight
  a lane, the layout and loop F was first built with;
* ``solve once`` (mode 4): block 0 alone sums and solves, a second grid
  barrier, and the other blocks read the state: no redundant reduction;
* the parts of F's iteration, results not the loop's: ``no solve`` (mode
  16: slot work, barrier, reduction), ``slot work + barrier`` (24) and
  ``barrier only`` (56).

An iteration's time is (a call forced to 33 iterations - a call of 1) / 32,
the stop thresholds set to 0; ``main call`` is a call at the default
thresholds. The card's name and power limit end the output.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import subprocess
import sys
from pathlib import Path

import torch

from ..ops import cuda_build, icp

SRC = Path(__file__).with_name("gn_loop_designs.cu")
DESIGNS = {0: "F", 3: "first build", 4: "solve once"}
PARTS = {16: "no solve", 24: "slot work + barrier", 56: "barrier only"}


def cell_inputs(dev, filtered: bool, n: int = 5):
    """The inputs of the n-th scan's alignment in the main cell (filtered)
    or the default one: its config, data maps, the model render of the scan
    before and the motion model's increment, after ``n - 1`` scans of
    ``SurfelSLAM``."""
    from ..config import odometry_config
    from ..core.pipeline import SurfelSLAM
    from ..core.preprocessing import preprocess_scan
    from ..io.simulation import circular_trajectory, default_world, render_scan
    cfg = odometry_config()
    cfg = cfg.replace(preprocess=dataclasses.replace(
        cfg.preprocess, use_filtered_vertexmap=filtered))
    world = default_world(seed=0, extent=45.0)
    gt = circular_trajectory(n, radius=18.0, step=1.5, device=dev)
    slam = SurfelSLAM(cfg, device=dev)
    for i in range(n - 1):
        s = render_scan(world, gt[i], cfg.data)
        slam.process_scan(s.points, s.labels, s.probs, s.valid)
    st = slam.state
    s = render_scan(world, gt[n - 1], cfg.data)
    data = preprocess_scan(s.points, s.labels, s.probs, s.valid,
                           st.timestamp < cfg.semantic.init_scans, cfg)
    return cfg, data, st.model_maps, st.last_increment


def _library() -> ctypes.CDLL:
    out = cuda_build.BUILD / "libgn_loop_designs.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(out),
           str(SRC)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc {SRC.name} failed:\n{done.stdout}"
                           f"{done.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.gn_loop_design.argtypes = ([ctypes.c_int]
                                   + icp._lib().gn_loop.argtypes[:-1]
                                   + [ctypes.c_void_p, ctypes.c_void_p])
    lib.gn_loop_design.restype = ctypes.c_int
    return lib


def _graph_ms(fn, iters: int) -> float:
    """Device ms of one call captured in a CUDA graph, replayed ``iters``
    times between two CUDA events after 10 replays."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    for _ in range(10):
        graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _runner(lib, dev):
    shared = torch.zeros(icp._SF + icp._SI, dtype=torch.float32, device=dev)

    def run(mode, sf, si, data, img, conf, mc, sem, cap):
        nslots = icp._blocks(data.vertex.shape[0] * data.vertex.shape[1])
        halves = torch.empty((2, icp.NPART, nslots), dtype=torch.float32,
                             device=dev)
        args, _keep = icp._kernel_args(sf, si, data, img, conf, mc, sem,
                                       halves, "gn_loop_design")
        grid = icp.gn_loop_grid(nslots, *icp.gn_loop_residency(dev.index))
        rc = lib.gn_loop_design(mode, *args, grid, cap, conf.delta,
                                conf.stopping_threshold, shared.data_ptr(),
                                torch.cuda.current_stream(dev).cuda_stream)
        cuda_build.check(rc, f"gn_loop_design mode {mode}")

    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gn_loop_designs: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    run = _runner(_library(), dev)
    inputs = {name: cell_inputs(dev, filtered)
              for name, filtered in (("main", True), ("default", False))}
    for name, (cfg, data, model, t0) in inputs.items():
        img = icp._pack_model_image(model)
        ic, mc, sem = cfg.icp, cfg.model, cfg.semantic.enabled
        for mode in DESIGNS:
            for cap in (1, 2, 33):
                sf, si = icp.gn_state(t0)
                icp.gn_loop(sf, si, data, img, ic, mc, sem, cap)
                sd, sid = icp.gn_state(t0)
                run(mode, sd, sid, data, img, ic, mc, sem, cap)
                if not (torch.equal(sf.view(torch.int32), sd.view(torch.int32))
                        and torch.equal(si, sid)):
                    raise AssertionError(f"{name}: design {DESIGNS[mode]} at "
                                         f"max_iterations {cap} is not F")
        print(f"[designs] {name}: {', '.join(DESIGNS.values())} equal to "
              "kernel F bit for bit at max_iterations 1, 2 and 33")

    cfg, data, model, t0 = inputs["main"]
    img = icp._pack_model_image(model)
    ic, mc, sem = cfg.icp, cfg.model, cfg.semantic.enabled
    forced = dataclasses.replace(ic, delta=0.0, stopping_threshold=0.0)
    sf0, si0 = icp.gn_state(t0)
    sf, si = sf0.clone(), si0.clone()

    def call(mode, conf, cap):
        def fn():
            sf.copy_(sf0)
            si.copy_(si0)
            run(mode, sf, si, data, img, conf, mc, sem, cap)
        return fn

    for turn in range(args.turns):
        for mode, label in {**DESIGNS, **PARTS}.items():
            t33 = _graph_ms(call(mode, forced, 33), 300)
            t1 = _graph_ms(call(mode, forced, 1), 1000)
            line = (f"[designs] turn {turn} {label:20s} (mode {mode:2d}): an "
                    f"iteration {(t33 - t1) / 32 * 1e3:.3f} us, a call of 1 "
                    f"{t1 * 1e3:.3f} us")
            if mode in DESIGNS:
                tm = _graph_ms(call(mode, ic, ic.max_iterations), 1000)
                line += f", main call {tm * 1e3:.3f} us"
            print(line, flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
